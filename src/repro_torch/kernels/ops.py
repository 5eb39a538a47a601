"""Public kernel entry points under the reference's names — port of the
three `src/repro/kernels/ops.py` wrappers this slice runs
(`dmf_fused_step` :52-73, `serve_topk_window` :190-219,
`recommend_topk_peruser` :250-273).

Each name is the wrapper object itself, so its ``launches`` counter is
the one the kernel module keeps. A wrapper runs its plain version only on
CPU tensors; on CUDA tensors it launches its kernel or raises.
"""
from repro_torch.kernels.dmf_update import dmf_fused_step
from repro_torch.kernels.serve_topk import serve_topk_window
from repro_torch.kernels.topk_scores import recommend_topk_peruser

KERNELS = (serve_topk_window, recommend_topk_peruser, dmf_fused_step)

__all__ = ["KERNELS", "dmf_fused_step", "recommend_topk_peruser", "serve_topk_window"]
