"""Zero-dependency client for the :mod:`libbicos_tpu_torch.serve` daemon.

The same client as ``libbicos_tpu.client``, with the same npz-over-HTTP
wire format, so either client talks to either package's daemon::

    from libbicos_tpu_torch.client import BicosClient

    c = BicosClient("http://localhost:8344")
    c.warmup((33, 2200, 3300))              # run one specialization once
    disp = c.match(stack0, stack1)          # numpy in, numpy out
    disp, corr = c.match(stack0, stack1, corrmap=True, threshold=0.96,
                         step=0.1, variance=2.0, limited=True)

The file imports only the stdlib and numpy: a scanner host without torch
loads a copy of it (importing it as ``libbicos_tpu_torch.client`` runs the
package's ``__init__``, which imports torch).
After each ``match``, ``last_timing`` holds the milliseconds of the
request's phases: ``encode`` (the npz body), ``request`` (the HTTP round
trip), ``decode`` (the npz reply), and the server's own phases from its
``Server-Timing`` header (``read``, ``load``, ``upload``, ``match``,
``download``, ``reply``) where the daemon sends one.
"""

from __future__ import annotations

import io
import json
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np


class ServerError(RuntimeError):
    """Raised when the daemon reports an error (HTTP 4xx/5xx)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class BicosClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8344",
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.last_timing: dict = {}
        self._server_timing = ""

    def _request(self, path: str, data: bytes | None = None,
                 params: dict | None = None) -> bytes:
        url = self.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        req = urllib.request.Request(
            url, data=data,
            headers={"Content-Type": "application/npz"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                self._server_timing = resp.headers.get("Server-Timing", "")
                return resp.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                msg = json.loads(body).get("error", body.decode())
            except Exception:
                msg = body.decode(errors="replace")
            raise ServerError(e.code, msg) from None

    def healthz(self) -> dict:
        return json.loads(self._request("/healthz"))

    def warmup(self, shape, dtype: str = "u8", **overrides) -> int:
        """Run a (shape, dtype[, config-override]) specialization once;
        returns the daemon's specialization count."""
        params = {"shape": "x".join(str(int(x)) for x in shape),
                  "dtype": dtype, **_clean(overrides)}
        return json.loads(self._request("/warmup", b"", params))["compiled"]

    def match(self, stack0: np.ndarray, stack1: np.ndarray, *,
              corrmap: bool = False, **overrides):
        """Run a match on the daemon. ``overrides`` take the CLI-style
        names: threshold, step, variance, limited, lr_maxdiff, no_dupes,
        disp_range."""
        t0 = time.perf_counter()
        buf = io.BytesIO()
        np.savez(buf, stack0=stack0, stack1=stack1)
        params = _clean(overrides)
        if corrmap:
            params["corrmap"] = 1
        t1 = time.perf_counter()
        body = self._request("/match", buf.getvalue(), params)
        t2 = time.perf_counter()
        out = np.load(io.BytesIO(body))
        res = ((out["disparity"], out["corrmap"]) if corrmap
               else out["disparity"])
        t3 = time.perf_counter()
        self.last_timing = {"encode": (t1 - t0) * 1e3,
                            "request": (t2 - t1) * 1e3,
                            "decode": (t3 - t2) * 1e3,
                            **_parse_server_timing(self._server_timing)}
        return res


def _clean(overrides: dict) -> dict:
    out = {}
    for k, v in overrides.items():
        if v is None:
            continue
        out[k] = int(v) if isinstance(v, bool) else v
    return out


def _parse_server_timing(header: str) -> dict:
    """``name;dur=ms`` entries of a ``Server-Timing`` header, as
    ``{"server_<name>": ms}``."""
    out = {}
    for entry in header.split(","):
        name, _, params = entry.strip().partition(";")
        for p in params.split(";"):
            key, _, val = p.strip().partition("=")
            if name and key == "dur":
                out[f"server_{name}"] = float(val)
    return out
