"""The torch/PyG patch surface, the counterpart of ``isplib_tpu.interop``:
``iSpLibPlugin.patch_pyg()`` / ``unpatch_pyg()``, ``@isplib_autotune`` and
``spmm_autotuned`` reroute an unmodified model's sparse products through
the port's SpMM on the caller's own tensors (``torch_bridge``);
``torch_baseline.train_torch_baseline`` is the plain-torch ``pt1`` column.
"""

from .torch_bridge import (
    clear_cache,
    iSpLibPlugin,
    isplib_autotune,
    spmm_autotuned,
    torch_spmm,
)

__all__ = [
    "iSpLibPlugin",
    "isplib_autotune",
    "spmm_autotuned",
    "torch_spmm",
    "clear_cache",
]
