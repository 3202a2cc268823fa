"""The port's ``BICOS_DEBUG`` checks (``libbicos_tpu_torch/debug.py``)
against the JAX package's: the same inputs raise, or pass, in both, with
the same message; ``match(device="cpu")`` runs them when enabled."""

import numpy as np
import pytest
import torch

from libbicos_tpu import debug as jd
from libbicos_tpu import descriptor as jdesc
from libbicos_tpu.config import TransformMode as JMode
from libbicos_tpu.config import actual_bits

import libbicos_tpu_torch as tb
from libbicos_tpu_torch import debug as td
from libbicos_tpu_torch.io import synthetic_stack_pair


def _outcome(check, *args, **kwargs):
    try:
        check(*args, **kwargs)
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


def _both(jcheck, tcheck, *args, **kwargs):
    """The JAX outcome, and the port's on numpy arrays and on tensors."""
    want = _outcome(jcheck, *args, **kwargs)
    as_tensors = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in args]
    for given in (args, as_tensors):
        assert _outcome(tcheck, *given, **kwargs) == want
    return want


def test_enabled_reads_env_at_call_time(monkeypatch):
    for value, on in ((None, False), ("0", False), ("", False), ("1", True),
                      ("yes", True)):
        if value is None:
            monkeypatch.delenv("BICOS_DEBUG", raising=False)
        else:
            monkeypatch.setenv("BICOS_DEBUG", value)
        assert td.enabled() == jd.enabled() == on
    assert td.CORR_SLACK == jd.CORR_SLACK
    assert issubclass(td.BicosDebugError, AssertionError)


def _words(n, mode, seed):
    s0, _, _ = synthetic_stack_pair(n, 4, 40, seed=seed)
    return np.array(jdesc.descriptor_words(s0, mode)), actual_bits(n, mode)


@pytest.mark.parametrize("n, mode", [(6, JMode.LIMITED), (33, JMode.LIMITED),
                                     (9, JMode.FULL), (12, JMode.FULL)])
@pytest.mark.parametrize("fault", ["none", "far", "at_width", "below_width",
                                   "capacity"])
def test_check_descriptor_words_matches(n, mode, fault):
    words, nbits = _words(n, mode, seed=n)
    if fault == "far":
        words[0, 0, -1] |= np.uint32(1 << 31)
    elif fault == "at_width" and nbits < 32 * words.shape[-1]:
        words[1, 2, nbits // 32] |= np.uint32(1 << (nbits % 32))
    elif fault == "below_width":
        words[0, 1, (nbits - 1) // 32] |= np.uint32(1 << ((nbits - 1) % 32))
    elif fault == "capacity":
        nbits = 32 * words.shape[-1] + 1
    want = _outcome(jd.check_descriptor_words, words, nbits)
    for given in (words, torch.from_numpy(words.view(np.int32))):
        assert _outcome(td.check_descriptor_words, given, nbits) == want
    if fault in ("far", "capacity"):
        assert want is not None


def _disp_cases():
    w = 40
    g = np.random.default_rng(5)
    i16 = np.full((4, w), -32768, np.int16)
    i16[0, 5] = 3
    f = np.full((4, w), np.nan, np.float32)
    f[0, :8] = g.uniform(-(w - 1), w - 1, 8)
    cases = {"int16 ok": (i16, None, False),
             "float ok": (f, None, True),
             "all invalid": (np.full((2, w), np.nan, np.float32), None,
                             False)}
    bad = i16.copy()
    bad[1, 1] = w + 5
    cases["int16 beyond W"] = (bad, None, False)
    neg = i16.copy()
    neg[2, 0] = -(w - 1)
    cases["int16 at -(W-1)"] = (neg, None, False)
    edge = f.copy()
    edge[1, 0] = (w - 1) + 0.9
    cases["float margin subpixel"] = (edge, None, True)
    cases["float margin integer"] = (edge, None, False)
    corr = np.full((4, w), np.nan, np.float32)
    corr[0, 0] = -1.0
    cases["corr -1"] = (i16, corr.copy(), False)
    corr[0, 1] = 1.0 + 0.5e-3
    cases["corr within slack"] = (i16, corr.copy(), False)
    corr[0, 2] = 1.5
    cases["corr 1.5"] = (i16, corr.copy(), False)
    low = np.full((4, w), np.nan, np.float32)
    low[3, 3] = -1.01
    cases["corr -1.01"] = (i16, low, False)
    return w, cases


W_DEBUG, DISP_CASES = _disp_cases()


@pytest.mark.parametrize("case", sorted(DISP_CASES))
def test_check_match_output_matches(case):
    disp, corr, subpixel = DISP_CASES[case]
    want = _both(jd.check_match_output, td.check_match_output, disp, corr,
                 W_DEBUG, subpixel=subpixel)
    expect_raise = case in ("int16 beyond W", "float margin integer",
                            "corr 1.5", "corr -1.01")
    assert (want is not None) == expect_raise


@pytest.mark.parametrize("cfg", [
    tb.Config(nxcorr_threshold=0.5, min_variance=1.0),
    tb.Config(nxcorr_threshold=0.5, subpixel_step=0.25),
    tb.Config(nxcorr_threshold=None),
])
def test_match_runs_the_checks_when_enabled(monkeypatch, cfg):
    """``match(device="cpu")`` calls ``check_match_output`` with its result
    under ``BICOS_DEBUG=1`` (and passes it), and not without."""
    s0, s1, _ = synthetic_stack_pair(7, 6, 40, seed=2)
    seen = []
    real = td.check_match_output

    def spy(disp, corr, w, subpixel):
        seen.append((disp.dtype, corr is None, w, subpixel))
        real(disp, corr, w, subpixel)

    monkeypatch.setattr(td, "check_match_output", spy)
    monkeypatch.delenv("BICOS_DEBUG", raising=False)
    tb.match(s0, s1, cfg, device="cpu")
    assert seen == []
    monkeypatch.setenv("BICOS_DEBUG", "1")
    tb.match(s0, s1, cfg, device="cpu")
    step = cfg.subpixel_step is not None
    assert seen == [(torch.float32 if step else torch.int16,
                     cfg.nxcorr_threshold is None, 40, step)]


def test_match_raises_on_a_planted_fault(monkeypatch):
    """A result out of range raises from ``match`` under ``BICOS_DEBUG``."""
    from libbicos_tpu_torch import pipeline

    s0, s1, _ = synthetic_stack_pair(7, 6, 40, seed=2)
    real = pipeline.agree_stage

    def broken(*args, **kwargs):
        disp, corr = real(*args, **kwargs)
        return disp, torch.full_like(corr, 2.0)

    monkeypatch.setattr(pipeline, "agree_stage", broken)
    monkeypatch.setenv("BICOS_DEBUG", "1")
    with pytest.raises(td.BicosDebugError, match="NXCORR"):
        tb.match(s0, s1, tb.Config(nxcorr_threshold=0.5), device="cpu")
    monkeypatch.setenv("BICOS_DEBUG", "0")
    tb.match(s0, s1, tb.Config(nxcorr_threshold=0.5), device="cpu")
