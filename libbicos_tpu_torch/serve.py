"""Persistent matching service: one warm process owns the card and serves
``match`` requests over HTTP.

The counterpart of ``libbicos_tpu.serve``, with the same routes, query
parameters, status codes, JSON error bodies and npz wire format, so that
any client of the JAX daemon works against this one unchanged. A fresh
process pays the CUDA context, the kernel library's build or load and the
first upload before its first match; a scanner pipeline keeps this one
process instead and pays them once, at warmup.

* **Engine**: a thread-safe wrapper around :func:`pipeline.match` /
  :func:`pipeline.match_batched_folded`, or :func:`sharding.match_sharded`
  / :func:`sharding.match_batched_sharded` on a mesh. A lock serializes
  the device work. Results come back as numpy inside the lock: the upload,
  the run and the download, each fenced by ``torch.cuda.synchronize()``,
  are one request's device work. The engine resolves its device once and
  runs every request on it, whichever thread serves the request (a new
  thread's current CUDA device is 0).
* **Specializations**: nothing is compiled per shape here; the registry
  keyed by ``(shape, dtype, config, corrmap)`` counts the specializations
  that have run once, and its cap (``max_specializations``, HTTP 400 past
  it) is kept so that the daemon answers as the JAX one does.
* **Wire format**: ``.npz`` in (one POST body), ``.npz`` out. Each
  ``/match`` reply carries a ``Server-Timing`` header with the
  milliseconds of its phases: ``read`` (the body), ``load`` (``np.load``),
  ``upload``, ``match``, ``download`` and ``reply`` (the npz encode).

Usage::

    python -m libbicos_tpu_torch.serve --port 8344 \\
        --warmup 33x2200x3300:u8 --threshold 0.96 --step 0.1 --variance 2.0
    python -m libbicos_tpu_torch.serve --device cpu ...   # on the CPU
    torchrun --nproc-per-node 4 -m libbicos_tpu_torch.serve --devices 4 ...

Endpoints:

* ``POST /match``: body an npz with ``stack0``, ``stack1`` ``(n, H, W)``
  arrays, or ``(batch, n, H, W)`` for the batched layout (folded on the
  host into the row axis, one run a request); query parameters override
  the engine's config (``threshold``, ``step``, ``variance``, ``limited``,
  ``lr_maxdiff``, ``no_dupes``, ``corrmap``, ``disp_range=MIN:MAX``).
  Reply: an npz with ``disparity`` (and ``corrmap`` if asked for),
  batch-shaped for a batched request.
* ``GET /healthz``: ``{"status": "ok", "compiled": N}``.
* ``POST /warmup?shape=NxHxW&dtype=u8``: run a specialization once, with
  the same config parameters as ``/match``.

``--devices N`` runs under ``torchrun``: rank 0 serves HTTP and, for each
request, sends every other rank a header and only that rank's row bands
(``sharding.RowBands``); every rank runs the same sharded match. When rank
0's server closes it tells the others to stop.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import json
import signal
import sys
import threading
import time
import traceback
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from . import pipeline as _pipeline
from . import sharding as _sharding
from .config import Config, Consistency, NoDuplicates, TransformMode


def _cfg_key(cfg: Config) -> tuple:
    v = cfg.variant
    vkey = (
        ("consistency", v.max_lr_diff, v.no_dupes)
        if isinstance(v, Consistency)
        else ("nodupes",)
    )
    return (
        cfg.nxcorr_threshold,
        cfg.subpixel_step,
        cfg.min_variance,
        cfg.mode,
        cfg.precision,
        vkey,
        cfg.disparity_range,
    )


# A follower waits for the next request as long as the daemon stays up.
_HEADER_TIMEOUT = datetime.timedelta(days=3650)


def _on_device(device: torch.device):
    """Make ``device`` this thread's current CUDA device for the block."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _fence(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


class Engine:
    """Thread-safe matching over one device (or a mesh).

    ``device=None`` is the current CUDA device, and raises without a card;
    pass ``"cpu"`` for the CPU. With a ``mesh`` the engine runs on
    ``mesh.device``. On a ``DistMesh`` every rank builds an Engine: rank 0
    serves (:meth:`match`), the others :meth:`follow` it.

    ``compiled_count``: the specializations, ``(shape, dtype, config,
    corrmap)``, that have run once. The port compiles nothing per shape;
    the count and its cap (``max_specializations``) answer as the JAX
    daemon's do."""

    def __init__(self, cfg: Config = Config(), *, backend: str = "auto",
                 mesh=None, max_specializations: int = 64, device=None):
        if mesh is None and device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the daemon runs on the card by default; "
                "pass device='cpu' (--device cpu) to run on the CPU")
        self.cfg = cfg
        self.backend = backend
        self.mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else _pipeline.resolve_device(device))
        self.max_specializations = max_specializations
        self._lock = threading.Lock()
        self._compiled: Dict[tuple, bool] = {}
        self._group = None
        if isinstance(mesh, _sharding.DistMesh) and mesh.size > 1:
            import torch.distributed as dist

            # Headers travel on a gloo group of their own: no collective of
            # the card's group waits for a request that may never come.
            self._group = dist.new_group(backend="gloo",
                                         timeout=_HEADER_TIMEOUT)

    def _run(self, s0, s1, cfg: Config, corrmap: bool, batch: int):
        """The device run on uploaded stacks (tensors, or RowBands on a
        mesh)."""
        if self.mesh is not None:
            fn = (_sharding.match_batched_sharded if batch
                  else _sharding.match_sharded)
            return fn(s0, s1, cfg, mesh=self.mesh, corrmap=corrmap,
                      backend=self.backend)
        if batch:
            return _pipeline.match_batched_folded(
                s0, s1, batch, cfg, corrmap=corrmap, backend=self.backend,
                device=self.device)
        return _pipeline.match(s0, s1, cfg, corrmap=corrmap,
                               backend=self.backend, device=self.device)

    def _upload(self, s0: np.ndarray, s1: np.ndarray, batch: int):
        if self.mesh is not None:
            return (_sharding.row_bands(s0, self.mesh, batch),
                    _sharding.row_bands(s1, self.mesh, batch))
        return tuple(
            torch.from_numpy(s if s.flags.writeable else s.copy()).to(
                self.device) for s in (s0, s1))

    def _send(self, s0: np.ndarray, s1: np.ndarray, cfg: Config,
              corrmap: bool, batch: int) -> None:
        """Rank 0 of a DistMesh: the request's header to every rank, then
        each rank its own row bands (as bytes: NCCL moves no uint16)."""
        import torch.distributed as dist

        header = {"shape": s0.shape, "dtype": str(s0.dtype), "cfg": cfg,
                  "key": _cfg_key(cfg), "corrmap": corrmap, "batch": batch}
        dist.broadcast_object_list([header], src=0, group=self._group)
        for r in range(1, self.mesh.size):
            for s in (s0, s1):
                band = _sharding.host_band(s, r, self.mesh.size)
                dist.send(torch.from_numpy(band).view(torch.uint8).to(
                    self.device), dst=r)

    def follow(self) -> None:
        """Ranks 1..N-1 of a DistMesh: run every request that rank 0 sends,
        on this rank's row bands, until rank 0 says stop."""
        import torch.distributed as dist

        with _on_device(self.device):
            while True:
                got = [None]
                dist.broadcast_object_list(got, src=0, group=self._group)
                header = got[0]
                if header is None:
                    return
                n, h, w = header["shape"]
                dtype = getattr(torch, header["dtype"])
                rows = -(-h // self.mesh.size)
                bands = []
                for _ in range(2):
                    buf = torch.empty(
                        (n, rows, w * dtype.itemsize), dtype=torch.uint8,
                        device=self.device)
                    dist.recv(buf, src=0)
                    bands.append(_sharding.RowBands(
                        (buf.view(dtype),), (n, h, w), header["batch"]))
                try:
                    self._run(*bands, header["cfg"], header["corrmap"],
                              header["batch"])
                except Exception:  # rank 0 answers the client; go on
                    traceback.print_exc()

    def close(self) -> None:
        """Rank 0 of a DistMesh: tell the followers to stop."""
        if self._group is not None:
            import torch.distributed as dist

            with self._lock:
                dist.broadcast_object_list([None], src=0, group=self._group)
                self._group = None

    def match(self, s0: np.ndarray, s1: np.ndarray,
              cfg: Optional[Config] = None, *, corrmap: bool = False,
              timings: Optional[dict] = None):
        """Run a match: numpy in, numpy out.

        Batched (4-d) requests are folded into the row axis on the host
        BEFORE taking the lock, so that concurrent requests stage while
        another runs. ``timings``, where given, receives the milliseconds
        of ``upload``, ``match`` and ``download``."""
        cfg = self.cfg if cfg is None else cfg
        key = (s0.shape, str(s0.dtype), _cfg_key(cfg), corrmap)
        if s0.ndim == 4 or s1.ndim == 4:
            # Validate the 4-d pair BEFORE folding, from either operand:
            # after the fold a coincidental batch*H product match would
            # pair rows of different images.
            if s0.ndim != 4 or s1.ndim != 4 or s0.shape != s1.shape:
                raise ValueError(
                    f"batched stacks must have identical (batch, n, H, W) "
                    f"shapes, got {s0.shape} vs {s1.shape}")
            batch = s0.shape[0]
            s0, s1 = _sharding.fold_host(s0), _sharding.fold_host(s1)
        else:
            batch = 0
        with self._lock:
            if (key not in self._compiled
                    and len(self._compiled) >= self.max_specializations):
                raise ValueError(
                    f"specialization limit reached "
                    f"({self.max_specializations}): refusing to compile a "
                    "new (shape, config) combination — raise "
                    "--max-specializations or reuse warmed configs")
            # Every check that needs no device, before anything is sent to
            # a follower: a rejected request leaves none of them waiting.
            _pipeline.check_stacks(s0.shape, s1.shape, s0.dtype, s1.dtype,
                                   cfg, corrmap)
            dev = self.device
            with _on_device(dev):
                t0 = _fence(dev)
                if self._group is not None:
                    self._send(s0, s1, cfg, corrmap, batch)
                a, b = self._upload(s0, s1, batch)
                t1 = _fence(dev)
                out = self._run(a, b, cfg, corrmap, batch)
                t2 = _fence(dev)
                out = (tuple(x.cpu().numpy() for x in out) if corrmap
                       else out.cpu().numpy())
                t3 = time.perf_counter()
            self._compiled[key] = True
        if timings is not None:
            timings.update(upload=(t1 - t0) * 1e3, match=(t2 - t1) * 1e3,
                           download=(t3 - t2) * 1e3)
        return out

    def warmup(self, shape: Tuple[int, ...], dtype: str = "uint8",
               cfg: Optional[Config] = None, *, corrmap: bool = False):
        """Run the specialization for ``shape``/``dtype`` once on a random
        pair, after building or loading the kernel library, so that the
        first real request pays neither."""
        if self.device.type == "cuda" and self.backend != "torch":
            from .kernels import _build

            _build.library()
        rng = np.random.default_rng(0)
        hi = np.iinfo(dtype).max
        s0 = rng.integers(0, hi + 1, shape, dtype=dtype)
        s1 = rng.integers(0, hi + 1, shape, dtype=dtype)
        self.match(s0, s1, cfg, corrmap=corrmap)

    @property
    def compiled_count(self) -> int:
        return len(self._compiled)


def _bool_param(s: str) -> bool:
    """Boolean query-param parsing that also understands Python/JSON
    spellings: ``?limited=False`` must not switch the flag on."""
    return s.strip().lower() not in ("0", "false", "no", "off", "")


def _cfg_from_params(base: Config, params: Dict[str, list],
                     want_corrmap: bool = False) -> Config:
    """Apply CLI-style query-param overrides to ``base`` (the reference
    CLI's flags, including its 'corrmap forces threshold -1' rule)."""

    def one(name, cast):
        vals = params.get(name)
        return cast(vals[0]) if vals else None

    cfg = base
    thr = one("threshold", float)
    if thr is not None:
        cfg = replace(cfg, nxcorr_threshold=None if thr <= 0 else thr)
    step = one("step", float)
    if step is not None:
        cfg = replace(cfg, subpixel_step=step)
    var = one("variance", float)
    if var is not None:
        cfg = replace(cfg, min_variance=var)
    lim = one("limited", _bool_param)
    if lim is not None:
        cfg = replace(
            cfg, mode=TransformMode.LIMITED if lim else TransformMode.FULL
        )
    lr = one("lr_maxdiff", int)
    nd = one("no_dupes", _bool_param)
    if lr is not None:
        cfg = replace(cfg, variant=Consistency(lr, bool(nd)))
    elif nd:
        cfg = replace(cfg, variant=NoDuplicates())
    dr = one("disp_range", str)
    if dr is not None:
        if dr == "":
            cfg = replace(cfg, disparity_range=None)
        else:
            lo, _, hi = dr.partition(":")
            try:
                cfg = replace(cfg, disparity_range=(int(lo), int(hi)))
            except ValueError:
                raise ValueError(
                    f"disp_range expects MIN:MAX integers, got {dr!r}")
    if want_corrmap and cfg.nxcorr_threshold is None:
        cfg = replace(cfg, nxcorr_threshold=-1.0)
    return cfg


# Default request-body cap: a batched request of 8 headline pairs is ~3.8
# GB of npz. The daemon has NO authentication: it is for a trusted rack
# network.
DEFAULT_MAX_BODY = 8 << 30
# Socket read timeout (seconds) between received chunks; a stalled client
# frees its handler thread after this. The device run is not under it.
DEFAULT_READ_TIMEOUT = 120.0


def make_handler(engine: Engine, *, max_body_bytes: int = DEFAULT_MAX_BODY,
                 read_timeout: float = DEFAULT_READ_TIMEOUT):
    class Handler(BaseHTTPRequestHandler):
        # one engine instance shared by all request threads
        timeout = read_timeout  # socket read timeout (BaseRequestHandler)

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[dict] = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "compiled": engine.compiled_count,
                })
                return
            self._json(404, {"error": f"unknown path {url.path}"})

        def do_POST(self):
            url = urlparse(self.path)
            params = parse_qs(url.query)
            try:
                if url.path == "/warmup":
                    shape = tuple(
                        int(x) for x in params["shape"][0].split("x")
                    )
                    dtype_s = params.get("dtype", ["u8"])[0]
                    if dtype_s not in _DTYPES:
                        raise ValueError(f"unknown dtype {dtype_s!r}")
                    dtype = _DTYPES[dtype_s]
                    want_corr = _bool_param(
                        params.get("corrmap", ["0"])[0])
                    cfg = _cfg_from_params(engine.cfg, params, want_corr)
                    engine.warmup(shape, dtype, cfg, corrmap=want_corr)
                    self._json(200, {"compiled": engine.compiled_count})
                    return
                if url.path != "/match":
                    self._json(404, {"error": f"unknown path {url.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", ""))
                except ValueError:
                    self._json(411, {"error": "Content-Length required"})
                    return
                if length > max_body_bytes:
                    # Reject before reading: the npz is buffered whole.
                    self._json(413, {
                        "error": f"body {length} bytes exceeds limit "
                                 f"{max_body_bytes}"})
                    return
                t0 = time.perf_counter()
                body = self.rfile.read(length)
                t1 = time.perf_counter()
                data = np.load(io.BytesIO(body))
                s0, s1 = data["stack0"], data["stack1"]
                del body, data
                t2 = time.perf_counter()
                want_corr = _bool_param(params.get("corrmap", ["0"])[0])
                cfg = _cfg_from_params(engine.cfg, params, want_corr)
                timings = {}
                out = engine.match(s0, s1, cfg, corrmap=want_corr,
                                   timings=timings)
                t3 = time.perf_counter()
                buf = io.BytesIO()
                if want_corr:
                    np.savez(buf, disparity=out[0], corrmap=out[1])
                else:
                    np.savez(buf, disparity=out)
                reply = buf.getvalue()
                timings = {"read": (t1 - t0) * 1e3, "load": (t2 - t1) * 1e3,
                           **timings,
                           "reply": (time.perf_counter() - t3) * 1e3}
                self._send(200, reply, "application/npz", {
                    "Server-Timing": ", ".join(
                        f"{k};dur={v:.3f}" for k, v in timings.items())})
            except (KeyError, ValueError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # engine errors -> 500, keep serving
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(engine: Engine, host: str = "127.0.0.1", port: int = 8344,
          *, warmup_shapes=(), ready_event: Optional[threading.Event] = None,
          max_body_bytes: int = DEFAULT_MAX_BODY,
          read_timeout: float = DEFAULT_READ_TIMEOUT):
    """Blocking server loop; runs ``warmup_shapes`` before serving. On
    leaving (an interrupt included) it closes the socket and stops the
    engine's followers."""
    try:
        for shape, dtype in warmup_shapes:
            engine.warmup(shape, dtype)
        httpd = ThreadingHTTPServer((host, port), make_handler(
            engine, max_body_bytes=max_body_bytes,
            read_timeout=read_timeout))
        if ready_event is not None:
            ready_event.set()
        try:
            httpd.serve_forever()
        finally:
            httpd.server_close()
    finally:
        engine.close()


_DTYPES = {"u8": "uint8", "uint8": "uint8", "u16": "uint16",
           "uint16": "uint16"}


def _parse_warmup(spec: str):
    shape_s, _, dtype_s = spec.partition(":")
    shape = tuple(int(x) for x in shape_s.split("x"))
    if len(shape) not in (3, 4):
        raise ValueError(
            f"warmup shape must be NxHxW or BxNxHxW, got {spec!r}")
    dtype = _DTYPES.get(dtype_s or "u8")
    if dtype is None:
        raise ValueError(
            f"warmup dtype must be one of {sorted(_DTYPES)}, got {spec!r}")
    return shape, dtype


def build_parser() -> argparse.ArgumentParser:
    """The JAX daemon's flags and defaults, plus ``--device``."""
    p = argparse.ArgumentParser(
        prog="python -m libbicos_tpu_torch.serve",
        description="Persistent BICOS matching service (one warm process "
                    "on the card, npz-over-HTTP). TRUSTED-NETWORK ONLY: the "
                    "daemon has no authentication or TLS — bind it to "
                    "localhost or a private rack network and front it with "
                    "a real proxy if wider exposure is needed.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8344)
    p.add_argument("-t", "--threshold", type=float, default=0.5)
    p.add_argument("-s", "--step", type=float, default=None)
    p.add_argument("-v", "--variance", type=float, default=None)
    p.add_argument("--limited", action="store_true")
    p.add_argument("-m", "--lr-maxdiff", type=int, default=None)
    p.add_argument("--no-dupes", action="store_true")
    p.add_argument("--disp-range", default=None, metavar="MIN:MAX",
                   help="default disparity range for served matches "
                        "(per-request disp_range param overrides)")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "cuda", "torch"],
                   help="Compute path: the CUDA kernels, or plain PyTorch.")
    p.add_argument("--device", default=None,
                   help="Where to run: the current CUDA device by default, "
                   "or e.g. 'cpu' or 'cuda:1'.")
    p.add_argument("--max-body-mb", type=int,
                   default=DEFAULT_MAX_BODY >> 20,
                   help="reject request bodies larger than this with 413 "
                        "(default %(default)s MiB — sized for batched "
                        "production stacks)")
    p.add_argument("--read-timeout", type=float,
                   default=DEFAULT_READ_TIMEOUT,
                   help="per-connection socket read timeout in seconds "
                        "(default %(default)s)")
    p.add_argument("--max-specializations", type=int, default=64,
                   help="reject requests that would add more than this "
                        "many distinct (shape, config) specializations "
                        "(default %(default)s)")
    p.add_argument("--devices", type=int, default=1,
                   help="H-band the pipeline over this many processes of "
                        "torch.distributed (run under torchrun)")
    p.add_argument("--warmup", action="append", default=[],
                   metavar="[Bx]NxHxW[:u8|u16]",
                   help="run these stack shapes once before serving "
                        "(repeatable; 4-component shapes warm the batched "
                        "layout)")
    return p


def _raise_interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    """Serve until SIGINT or SIGTERM (a service manager's stop, or a shell
    whose background jobs ignore SIGINT); returns 0 once every rank has
    stopped."""
    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _raise_interrupt)
    p = build_parser()
    args = p.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the daemon runs on the card by "
                           "default; pass --device cpu to run on the CPU")

    variant = (Consistency(args.lr_maxdiff, args.no_dupes)
               if args.lr_maxdiff is not None
               else NoDuplicates())
    drange = None
    if args.disp_range:
        try:
            lo, _, hi = args.disp_range.partition(":")
            drange = (int(lo), int(hi))
        except ValueError:
            p.error(f"--disp-range expects MIN:MAX integers, "
                    f"got {args.disp_range!r}")
    cfg = Config(
        nxcorr_threshold=None if args.threshold <= 0 else args.threshold,
        subpixel_step=args.step,
        min_variance=args.variance,
        mode=(TransformMode.LIMITED if args.limited else TransformMode.FULL),
        variant=variant,
        disparity_range=drange,
    )
    shapes = [_parse_warmup(s) for s in args.warmup]
    mesh, lead, owned = None, True, False
    if args.devices > 1:
        import torch.distributed as dist

        from .cli import _distributed

        owned = not dist.is_initialized()
        mesh, _, lead = _distributed(args.devices, args.device,
                                     "libbicos_tpu_torch.serve")
    try:
        engine = Engine(cfg, backend=args.backend, mesh=mesh,
                        max_specializations=args.max_specializations,
                        device=args.device)
        if not lead:
            try:
                engine.follow()
            except KeyboardInterrupt:
                pass
            return 0
        print(f"serving on http://{args.host}:{args.port} "
              f"(warmup: {len(shapes)} shapes)", flush=True)
        try:
            serve(engine, args.host, args.port, warmup_shapes=shapes,
                  max_body_bytes=args.max_body_mb << 20,
                  read_timeout=args.read_timeout)
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
