"""Drop-in ``pybicos``-compatible surface.

The counterpart of ``libbicos_tpu.pybicos_compat``: users of the
reference's ctypes package can ``import libbicos_tpu_torch.pybicos_compat
as pybicos`` and keep their code:

* a mutable :class:`Config` with the same property names, the None <-> -1
  sentinels of the ctypes wrapper and the C ABI's defaults (threshold 0.5,
  LIMITED, NoDuplicates);
* :func:`match`, taking lists of 2-D arrays and returning owned numpy
  ``(disparity, corrmap)``;
* :func:`invalid_disparity` and :func:`float_disparity`.

Two measured behaviours of the C ABI are kept (the JAX module pins them
against the compiled reference binding):

1. NXCORR cannot be turned off: the C ABI only assigns a threshold that is
   ``>= 0``, and the C++ default is 0.5, so None or a negative threshold
   runs at 0.5.
2. The disparity is always float32: with a threshold in effect the
   reference's CPU backend converts the int16 map with a plain cast, so on
   the integer path invalid pixels stay -32768.0 (not NaN). The corrmap is
   always real.

The JAX module's corrected struct layout (the reference's CPU builds shift
every field after ``mode``) is the one kept here; ``precision`` is honoured.

``device`` follows the port's rule: the card by default, ``"cpu"`` when
asked.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence, Tuple

import numpy as np

from . import config as _config
from . import pipeline as _pipeline


class TransformMode(Enum):
    LIMITED = 0
    FULL = 1


class Precision(Enum):
    SINGLE = 0
    DOUBLE = 1


class VariantType(Enum):
    NO_DUPLICATES = 0
    CONSISTENCY = 1


class Config:
    """Mutable config mirroring the ctypes wrapper's surface."""

    def __init__(self):
        # The defaults of BICOS_CreateDefaultConfig.
        self.nxcorr_threshold = 0.5
        self._subpixel_step = -1.0
        self._min_variance = -1.0
        self._mode = TransformMode.LIMITED.value
        self._precision = Precision.SINGLE.value
        self._variant_type = VariantType.NO_DUPLICATES.value
        self._max_lr_diff = 1
        self._no_dupes = 0

    @property
    def subpixel_step(self) -> Optional[float]:
        return None if self._subpixel_step < 0 else self._subpixel_step

    @subpixel_step.setter
    def subpixel_step(self, value):
        self._subpixel_step = -1.0 if value is None else float(value)

    @property
    def min_variance(self) -> Optional[float]:
        return None if self._min_variance < 0 else self._min_variance

    @min_variance.setter
    def min_variance(self, value):
        self._min_variance = -1.0 if value is None else float(value)

    @property
    def mode(self) -> TransformMode:
        return TransformMode(self._mode)

    @mode.setter
    def mode(self, value):
        self._mode = value.value if isinstance(value, TransformMode) else value

    @property
    def precision(self) -> Precision:
        return Precision(self._precision)

    @precision.setter
    def precision(self, value):
        self._precision = (
            value.value if isinstance(value, Precision) else value
        )

    @property
    def variant(self):
        if self._variant_type == VariantType.NO_DUPLICATES.value:
            return "NoDuplicates"
        return {
            "type": "Consistency",
            "max_lr_diff": self._max_lr_diff,
            "no_dupes": bool(self._no_dupes),
        }

    def set_no_duplicates(self):
        self._variant_type = VariantType.NO_DUPLICATES.value

    def set_consistency(self, max_lr_diff: int = 1, no_dupes: bool = False):
        self._variant_type = VariantType.CONSISTENCY.value
        self._max_lr_diff = max_lr_diff
        self._no_dupes = 1 if no_dupes else 0

    def __repr__(self):
        return "\n".join([
            "Config(",
            f"  nxcorr_threshold={self.nxcorr_threshold}",
            f"  subpixel_step={self.subpixel_step}",
            f"  min_variance={self.min_variance}",
            f"  mode={self.mode.name}",
            f"  precision={self.precision.name}",
            f"  variant={self.variant}",
            ")",
        ])

    def _to_native(self) -> _config.Config:
        """The engine's ``Config`` under the C ABI's sentinel rules: a None
        or negative threshold keeps the C++ default 0.5, so NXCORR is always
        on through this surface."""
        thr = self.nxcorr_threshold
        if thr is None or thr < 0:
            thr = 0.5
        if self._variant_type == VariantType.CONSISTENCY.value:
            variant = _config.Consistency(
                max_lr_diff=self._max_lr_diff, no_dupes=bool(self._no_dupes)
            )
        else:
            variant = _config.NoDuplicates()
        return _config.Config(
            nxcorr_threshold=thr,
            subpixel_step=self.subpixel_step,
            min_variance=self.min_variance,
            mode=_config.TransformMode(self._mode),
            precision=_config.Precision(self._precision),
            variant=variant,
        )


def match(
    stack0: Sequence[np.ndarray],
    stack1: Sequence[np.ndarray],
    cfg: Optional[Config] = None,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """pybicos-compatible match: lists of 2-D images in, owned numpy arrays
    ``(disparity, corrmap)`` out, on ``device`` (None: the card).

    A threshold is always in effect, so the disparity is always float32 (a
    plain cast of the int16 map on the integer path, invalid -32768.0; the
    subpixel map with NaN invalid) and the corrmap is a real ``(H, W)``
    float32 NXCORR map."""
    if (isinstance(stack0, (list, tuple)) and not stack0) or (
        isinstance(stack1, (list, tuple)) and not stack1
    ):
        raise ValueError("Empty image stacks")
    if cfg is None:
        cfg = Config()
    native = cfg._to_native()
    s0 = np.stack([np.ascontiguousarray(im) for im in stack0])
    s1 = np.stack([np.ascontiguousarray(im) for im in stack1])
    disp, corr = _pipeline.match(s0, s1, native, corrmap=True, device=device)
    return (float_disparity(disp.cpu().numpy()),
            np.ascontiguousarray(corr.cpu().numpy()))


def invalid_disparity(dtype):
    if dtype == np.float32:
        return float("nan")
    if dtype == np.int16:
        return np.int16(-32768)
    raise ValueError(f"Unsupported dtype for invalid_disparity: {dtype}")


def float_disparity(disparity) -> np.ndarray:
    """The reference CPU backend's output convention: an int16 disparity
    becomes float32 by a plain cast (invalid pixels stay -32768.0, not
    NaN); a float32 one passes through."""
    if hasattr(disparity, "detach"):
        disparity = disparity.detach().cpu().numpy()
    d = np.asarray(disparity)
    if d.dtype == np.float32:
        return d
    return d.astype(np.float32)
