"""The port's serving daemon (libbicos_tpu_torch/serve.py) on the CPU: the
cases of ``tests/test_serve.py`` against the port's daemon, each reply
equal to the port's in-process ``match``; the JAX daemon (``backend="xla"``)
and the port's side by side on the same seeded requests (disparities
exact with the same NaN mask, corrmaps within 4e-6, the same status codes
and ``/healthz`` keys); each package's client against the other's daemon.
"""

import http.client
import io
import json
import socket
import threading
import urllib.request

import numpy as np
import pytest

import libbicos_tpu as jb
from libbicos_tpu import serve as jserve

import libbicos_tpu_torch as tb
from libbicos_tpu_torch.serve import Engine, serve

CORR_TOL = dict(rtol=4e-6, atol=4e-6)
CFG = tb.Config(nxcorr_threshold=0.5, min_variance=1.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(engine, **kwargs) -> str:
    port = _free_port()
    ready = threading.Event()
    serve_fn = serve if isinstance(engine, Engine) else jserve.serve
    threading.Thread(target=serve_fn, args=(engine, "127.0.0.1", port),
                     kwargs={"ready_event": ready, **kwargs},
                     daemon=True).start()
    assert ready.wait(120), "server failed to start"
    return f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def server():
    engine = Engine(CFG, device="cpu")
    base = _start(engine, warmup_shapes=[((4, 8, 24), "uint8")])
    assert engine.compiled_count == 1  # warmup ran before serving
    return base, engine


def _post(url: str, body: bytes, ctype: str = "application/npz"):
    req = urllib.request.Request(
        url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _stacks(rng, n=4, h=8, w=24, dtype=np.uint8):
    hi = np.iinfo(dtype).max + 1
    s0 = rng.integers(0, hi, (n, h, w), dtype=dtype)
    s1 = rng.integers(0, hi, (n, h, w), dtype=dtype)
    return s0, s1


def _match(s0, s1, cfg=CFG, **kw):
    out = tb.match(s0, s1, cfg, device="cpu", **kw)
    if isinstance(out, tuple):
        return tuple(x.numpy() for x in out)
    return out.numpy()


def test_healthz(server):
    base, engine = server
    with urllib.request.urlopen(base + "/healthz") as resp:
        obj = json.loads(resp.read())
    assert obj["status"] == "ok"
    assert obj["compiled"] == engine.compiled_count >= 1


def test_match_roundtrip(server, rng):
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(base + "/match", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    np.testing.assert_array_equal(out["disparity"], _match(s0, s1))


def test_match_param_overrides(server, rng):
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?threshold=0.4&lr_maxdiff=1&no_dupes=1&corrmap=1",
        _npz(stack0=s0, stack1=s1),
    )
    assert status == 200
    out = np.load(io.BytesIO(body))
    cfg = tb.Config(nxcorr_threshold=0.4, min_variance=1.0,
                    variant=tb.Consistency(1, True))
    wd, wc = _match(s0, s1, cfg, corrmap=True)
    np.testing.assert_array_equal(out["disparity"], wd)
    np.testing.assert_array_equal(out["corrmap"], wc)


def test_match_threshold_zero_disables_nxcorr(server, rng):
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?threshold=0", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    want = _match(s0, s1, tb.Config(nxcorr_threshold=None, min_variance=1.0))
    np.testing.assert_array_equal(out["disparity"], want)


def test_bad_requests(server, rng):
    base, _ = server
    status, body = _post(base + "/match", _npz(stack0=np.zeros((2, 4, 8))))
    assert status == 400  # missing stack1
    assert b"error" in body
    # invalid stacks (n=1 < minimum) -> clean 400, server keeps serving
    s0 = np.zeros((1, 4, 8), dtype=np.uint8)
    status, _ = _post(base + "/match", _npz(stack0=s0, stack1=s0))
    assert status == 400
    s0, s1 = _stacks(rng)
    status, _ = _post(base + "/match", _npz(stack0=s0, stack1=s1))
    assert status == 200
    status, _ = _post(base + "/nope", b"")
    assert status == 404


def test_batched_shape_mismatch_rejected(server, rng):
    """Mismatched 4-d pairs whose batch*H products coincide are a 400:
    Engine.match validates them before the host fold."""
    base, _ = server
    s0, s1 = _stacks(rng)  # (4, 8, 24)
    b0 = np.stack([s0, s0])                      # (2, 4, 8, 24)
    b1 = np.stack([s1[:, :4], s1[:, 4:],
                   s1[:, :4] ^ 1, s1[:, 4:] ^ 1])  # (4, 4, 4, 24)
    assert b0.size == b1.size
    status, body = _post(base + "/match", _npz(stack0=b0, stack1=b1))
    assert status == 400
    assert b"identical" in body
    status, _ = _post(base + "/match", _npz(stack0=b0, stack1=s1))
    assert status == 400


def test_warmup_endpoint(server):
    base, engine = server
    before = engine.compiled_count
    status, body = _post(base + "/warmup?shape=4x6x16&dtype=u8", b"")
    assert status == 200
    assert json.loads(body)["compiled"] == before + 1


def test_parse_warmup_validates():
    from libbicos_tpu_torch.serve import _parse_warmup

    assert _parse_warmup("4x8x24") == ((4, 8, 24), "uint8")
    assert _parse_warmup("4x8x24:uint16") == ((4, 8, 24), "uint16")
    with pytest.raises(ValueError, match="dtype"):
        _parse_warmup("4x8x24:float32")
    with pytest.raises(ValueError, match="NxHxW"):
        _parse_warmup("4x8")


def test_warmup_endpoint_rejects_bad_dtype(server):
    base, _ = server
    status, body = _post(base + "/warmup?shape=4x6x16&dtype=f32", b"")
    assert status == 400
    assert b"dtype" in body


def test_client_roundtrip(server, rng):
    from libbicos_tpu_torch.client import BicosClient, ServerError

    base, engine = server
    c = BicosClient(base, timeout=60)
    assert c.healthz()["status"] == "ok"
    s0, s1 = _stacks(rng)
    disp = c.match(s0, s1)
    np.testing.assert_array_equal(disp, _match(s0, s1))
    assert set(c.last_timing) == {
        "encode", "request", "decode", "server_read", "server_load",
        "server_upload", "server_match", "server_download", "server_reply"}
    assert all(v >= 0 for v in c.last_timing.values())
    d2, corr = c.match(s0, s1, corrmap=True, threshold=0.4)
    wd, wc = _match(s0, s1, tb.Config(nxcorr_threshold=0.4, min_variance=1.0),
                    corrmap=True)
    np.testing.assert_array_equal(d2, wd)
    np.testing.assert_array_equal(corr, wc)
    before = engine.compiled_count
    assert c.warmup((4, 5, 16)) == before + 1
    with pytest.raises(ServerError, match="dtype"):
        c.warmup((4, 5, 16), dtype="f64")


def test_engine_sharded_mesh(rng):
    """An Engine on a mesh runs the sharded path, on row bands."""
    from libbicos_tpu_torch.sharding import make_mesh

    cfg = tb.Config(nxcorr_threshold=0.5)
    engine = Engine(cfg, mesh=make_mesh(4, virtual=True, device="cpu"))
    s0, s1 = _stacks(rng, 4, 10, 24)
    got = engine.match(s0, s1)
    np.testing.assert_array_equal(got, _match(s0, s1, cfg))
    b0, b1 = np.stack([s0, s0 ^ np.uint8(9)]), np.stack([s1, s1])
    got_b = engine.match(b0, b1)
    want_b = tb.match_batched(b0, b1, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(got_b, want_b)


def test_match_corrmap_without_threshold(server, rng):
    """corrmap with thresholding disabled serves: the CLI's 'corrmap
    forces threshold -1' rule applies to query params too."""
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?threshold=0&corrmap=1", _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    want_d, want_c = _match(
        s0, s1, tb.Config(nxcorr_threshold=-1.0, min_variance=1.0),
        corrmap=True)
    np.testing.assert_array_equal(out["disparity"], want_d)
    np.testing.assert_array_equal(out["corrmap"], want_c)


def test_bool_params_accept_python_spellings(server, rng):
    """?limited=False must not switch the flag on; corrmap=False is
    honoured."""
    base, _ = server
    s0, s1 = _stacks(rng)
    status, body = _post(
        base + "/match?limited=False&corrmap=False",
        _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))
    assert "corrmap" not in out.files
    want = _match(s0, s1, tb.Config(nxcorr_threshold=0.5, min_variance=1.0,
                                    mode=tb.TransformMode.FULL))
    np.testing.assert_array_equal(out["disparity"], want)


def test_warmup_compiles_corrmap_specialization(server):
    """corrmap is part of the specialization key; /warmup?corrmap=1 runs
    it."""
    base, engine = server
    before = engine.compiled_count
    status, body = _post(base + "/warmup?shape=4x8x24&dtype=u8&corrmap=1",
                         b"")
    assert status == 200
    assert engine.compiled_count == before + 1
    key_corr = [k for k in engine._compiled if k[-1]]
    assert key_corr, "no corrmap=True specialization registered"


def test_match_batched_over_http(server, rng):
    """(batch, n, H, W) bodies run the batched layout and come back
    batch-shaped, equal per pair to single matches."""
    base, _ = server
    s0, s1 = _stacks(rng)
    b0 = np.stack([s0, s0 ^ np.uint8(3)])
    b1 = np.stack([s1, s1])
    status, body = _post(base + "/match", _npz(stack0=b0, stack1=b1))
    assert status == 200
    out = np.load(io.BytesIO(body))["disparity"]
    assert out.shape == (2, s0.shape[1], s0.shape[2])
    for k in range(2):
        np.testing.assert_array_equal(out[k], _match(b0[k], b1[k]))


def test_concurrent_batched_requests(server, rng):
    """Folding runs outside the engine lock: concurrent batched posts still
    give per-pair-correct, batch-shaped results."""
    base, _ = server
    s0, s1 = _stacks(rng)
    results = {}

    def one(k):
        b0 = np.stack([s0 ^ np.uint8(k), s0 ^ np.uint8(k + 16)])
        b1 = np.stack([s1, s1])
        status, body = _post(base + "/match", _npz(stack0=b0, stack1=b1))
        results[k] = (status, np.load(io.BytesIO(body))["disparity"], b0, b1)

    threads = [threading.Thread(target=one, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert sorted(results) == [0, 1, 2]
    for k, (status, out, b0, b1) in results.items():
        assert status == 200
        for j in range(2):
            np.testing.assert_array_equal(out[j], _match(b0[j], b1[j]))


def test_warmup_batched_shape(server):
    base, engine = server
    before = engine.compiled_count
    status, _ = _post(base + "/warmup?shape=3x4x8x24&dtype=u8", b"")
    assert status == 200
    assert engine.compiled_count == before + 1


def test_mixed_ndim_batch_rejected(server, rng):
    """A 3-d stack0 with a 4-d stack1 (or vice versa) is a clean 400."""
    base, _ = server
    s0, s1 = _stacks(rng)
    b1 = np.stack([s1, s1])  # (2, 4, 8, 24)
    status, body = _post(base + "/match", _npz(stack0=s0, stack1=b1))
    assert status == 400 and b"batched stacks" in body
    status, body = _post(base + "/match", _npz(stack0=b1, stack1=s0))
    assert status == 400 and b"batched stacks" in body


@pytest.fixture(scope="module")
def capped_server():
    """Server with a 4 KiB body cap for the 413 path."""
    return _start(Engine(CFG, device="cpu"), max_body_bytes=4096)


def test_oversized_body_413(capped_server, rng):
    """Bodies beyond --max-body-mb are rejected with 413 before they are
    read, and the server keeps serving."""
    big0 = rng.integers(0, 256, (4, 32, 64), dtype=np.uint8)
    status, body = _post(capped_server + "/match",
                         _npz(stack0=big0, stack1=big0))
    assert status == 413
    assert b"exceeds limit" in body
    s0, s1 = _stacks(rng, 4, 4, 12)
    status, body = _post(capped_server + "/match", _npz(stack0=s0, stack1=s1))
    assert status == 200
    assert np.load(io.BytesIO(body))["disparity"].shape == (4, 12)


def test_disp_range_param(server, rng):
    """?disp_range=MIN:MAX sets Config.disparity_range per request."""
    s0, s1 = _stacks(rng)
    status, body = _post(server[0] + "/match?disp_range=0:8",
                         _npz(stack0=s0, stack1=s1))
    assert status == 200
    out = np.load(io.BytesIO(body))["disparity"]
    want = _match(s0, s1, tb.Config(nxcorr_threshold=0.5, min_variance=1.0,
                                    disparity_range=(0, 8)))
    np.testing.assert_array_equal(out, want)
    status, body = _post(server[0] + "/match?disp_range=zz",
                         _npz(stack0=s0, stack1=s1))
    assert status == 400 and b"disp_range" in body


def test_specialization_cap(rng):
    """New (shape, config) combinations beyond max_specializations are
    rejected."""
    engine = Engine(CFG, device="cpu", max_specializations=1)
    s0, s1 = _stacks(rng, n=4, h=4, w=12)
    engine.match(s0, s1)
    engine.match(s0, s1)  # reuse is fine
    with pytest.raises(ValueError, match="specialization limit"):
        engine.match(s0, s1, tb.Config(nxcorr_threshold=0.7))


# ---------------------------------------------------------------------------
# The JAX daemon and the port's, side by side.


def _daemons(max_specializations=64, **kw):
    """(JAX daemon, port daemon) with the same config."""
    jcfg = jb.Config(nxcorr_threshold=0.5, min_variance=1.0)
    jbase = _start(jserve.Engine(jcfg, backend="xla",
                                 max_specializations=max_specializations),
                   **kw)
    tbase = _start(Engine(tb.config_from_reference(jcfg), device="cpu",
                          max_specializations=max_specializations), **kw)
    return jbase, tbase


@pytest.fixture(scope="module")
def daemons():
    """Both daemons with a 64 KiB body cap and a cap of 12
    specializations."""
    return _daemons(12, max_body_bytes=64 << 10)


def _raw(base, method, path, body=None, headers=None):
    """One request with exactly the given headers (none added)."""
    host, port = base.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=120)
    conn.putrequest(method, path, skip_accept_encoding=True)
    for k, v in (headers or {}).items():
        conn.putheader(k, v)
    conn.endheaders()
    if body:
        conn.send(body)
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read()
    conn.close()
    return out


def _assert_same_reply(jrep, trep, what):
    (js, jct, jbody), (ts, tct, tbody) = jrep, trep
    assert (ts, tct) == (js, jct), what
    if js != 200:
        assert set(json.loads(tbody)) == set(json.loads(jbody)), what
        return
    if jct == "application/json":
        assert set(json.loads(tbody)) == set(json.loads(jbody)), what
        return
    jo, to = np.load(io.BytesIO(jbody)), np.load(io.BytesIO(tbody))
    assert sorted(to.files) == sorted(jo.files), what
    jd, td = jo["disparity"], to["disparity"]
    assert (td.dtype, td.shape) == (jd.dtype, jd.shape), what
    if jd.dtype.kind == "f":
        np.testing.assert_array_equal(np.isnan(td), np.isnan(jd), what)
        np.testing.assert_array_equal(td[~np.isnan(jd)], jd[~np.isnan(jd)],
                                      what)
    else:
        np.testing.assert_array_equal(td, jd, what)
    if "corrmap" in jo.files:
        np.testing.assert_allclose(to["corrmap"], jo["corrmap"],
                                   equal_nan=True, err_msg=what, **CORR_TOL)


def test_daemons_agree(daemons):
    """The same seeded requests to both daemons: the same status codes,
    content types and JSON keys; disparities exact with the same NaN mask,
    corrmaps within 4e-6; the same specialization counts throughout, up to
    the cap."""
    jbase, tbase = daemons
    rng = np.random.default_rng(21)
    u8 = _stacks(rng, 5, 6, 28)
    u16 = _stacks(rng, 4, 5, 20, np.uint16)
    b8 = (np.stack([u8[0], u8[0] ^ np.uint8(7)]), np.stack([u8[1], u8[1]]))
    npz = "application/npz"
    cases = [
        ("GET", "/healthz", None),
        ("POST", "/match", _npz(stack0=u8[0], stack1=u8[1])),
        ("POST", "/match?corrmap=1&step=0.25", _npz(stack0=u8[0],
                                                    stack1=u8[1])),
        ("POST", "/match?corrmap=1&lr_maxdiff=1&no_dupes=1&limited=1",
         _npz(stack0=u8[0], stack1=u8[1])),
        ("POST", "/match?lr_maxdiff=2&step=0.5&variance=0",
         _npz(stack0=u16[0], stack1=u16[1])),
        ("POST", "/match?disp_range=-2:9&corrmap=1",
         _npz(stack0=u8[0], stack1=u8[1])),
        ("POST", "/match?threshold=0&corrmap=1", _npz(stack0=u16[0],
                                                      stack1=u16[1])),
        ("POST", "/match", _npz(stack0=b8[0], stack1=b8[1])),
        ("POST", "/warmup?shape=4x5x20&dtype=u16&corrmap=1", b""),
        ("GET", "/healthz", None),
        # Each bad request.
        ("POST", "/match", _npz(stack0=u8[0])),
        ("POST", "/match", _npz(stack0=u8[0][:1], stack1=u8[1][:1])),
        ("POST", "/match", _npz(stack0=b8[0], stack1=u8[1])),
        ("POST", "/match", _npz(stack0=b8[0], stack1=np.stack([u8[1]] * 4))),
        ("POST", "/match?disp_range=zz", _npz(stack0=u8[0], stack1=u8[1])),
        ("POST", "/warmup?shape=4x5x20&dtype=f32", b""),
        ("POST", "/warmup?dtype=u8", b""),
        ("POST", "/nope", b""),
        ("GET", "/nope", None),
        ("POST", "/match", _npz(stack0=np.zeros((4, 64, 128), np.uint8),
                                stack1=np.zeros((4, 64, 128), np.uint8))),
    ]
    for k in range(8):  # new configs up to the cap of 12, then a 400
        cases.append(("POST", f"/match?threshold={0.3 + 0.05 * k}",
                      _npz(stack0=u8[0], stack1=u8[1])))
    cases.append(("GET", "/healthz", None))
    statuses = []
    for method, path, body in cases:
        headers = ({"Content-Type": npz, "Content-Length": str(len(body))}
                   if body is not None else {})
        jrep = _raw(jbase, method, path, body, headers)
        trep = _raw(tbase, method, path, body, headers)
        _assert_same_reply(jrep, trep, f"{method} {path}")
        if path == "/healthz":
            assert json.loads(trep[2]) == json.loads(jrep[2])
        statuses.append(trep[0])
    # Threshold 0.5 is the default config's, already counted: the cap of 12
    # lets it through and refuses the last three.
    assert statuses == ([200] * 10 + [400] * 7 + [404, 404, 413]
                        + [200] * 5 + [400] * 3 + [200])
    # 411: a POST to /match without Content-Length.
    jrep = _raw(jbase, "POST", "/match", None, {"Content-Type": npz})
    trep = _raw(tbase, "POST", "/match", None, {"Content-Type": npz})
    assert trep[0] == jrep[0] == 411
    _assert_same_reply(jrep, trep, "411")


def test_clients_cross_daemons():
    """The port's client against the JAX daemon and the JAX client against
    the port's: the same answers."""
    from libbicos_tpu import client as jclient

    from libbicos_tpu_torch import client as tclient

    jbase, tbase = _daemons()
    rng = np.random.default_rng(5)
    s0, s1 = _stacks(rng, 5, 6, 28)
    tj = tclient.BicosClient(jbase, timeout=120)
    jt = jclient.BicosClient(tbase, timeout=120)
    assert tj.healthz().keys() == jt.healthz().keys() == {"status",
                                                          "compiled"}
    d1, c1 = tj.match(s0, s1, corrmap=True, threshold=0.5)
    d2, c2 = jt.match(s0, s1, corrmap=True, threshold=0.5)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_allclose(c1, c2, equal_nan=True, **CORR_TOL)
    assert "server_match" not in tj.last_timing  # the JAX daemon sends none
    for client in (tj, jt):
        with pytest.raises(Exception, match="dtype"):
            client.warmup((4, 5, 16), dtype="f64")
        assert client.warmup((4, 6, 28)) >= 1
