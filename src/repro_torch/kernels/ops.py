"""Public kernel entry points under the reference's names — port of the
`src/repro/kernels/ops.py` wrappers (`dmf_grads` :30-49, `dmf_fused_step`
:52-73, `dmf_fused_step_dp` :76-101, `dp_clip_noise` :104-127,
`gossip_mix_op` :130-137, `recommend_topk` :140-155, `serve_topk`
:158-187, `serve_topk_window` :190-219, `serve_topk_window_quant`
:222-247, `recommend_topk_peruser` :250-273), of the noise stream
`kernels/dp_noise.gauss_counter`, `serve_topk_tiled_quant`, kernel 6
reading the tiled store in place, and `serve_topk_rows`, kernel 5 reading
the serving engine's state in place.

Each name is the wrapper object itself, so its ``launches`` counter is
the one the kernel module keeps. A wrapper runs its plain version only on
CPU tensors; on CUDA tensors it launches its kernel or raises.
"""
from repro_torch.kernels.dmf_update import dmf_fused_step, dmf_fused_step_dp, dmf_grads
from repro_torch.kernels.dp_noise import dp_clip_noise, gauss_counter
from repro_torch.kernels.gossip_mix import gossip_mix_op
from repro_torch.kernels.serve_topk import (serve_topk, serve_topk_rows, serve_topk_tiled_quant,
                                            serve_topk_window, serve_topk_window_quant)
from repro_torch.kernels.topk_scores import recommend_topk, recommend_topk_peruser

KERNELS = (serve_topk_window, recommend_topk_peruser, dmf_fused_step, dmf_fused_step_dp,
           dp_clip_noise, gauss_counter, serve_topk, serve_topk_window_quant,
           recommend_topk, dmf_grads, gossip_mix_op, serve_topk_tiled_quant, serve_topk_rows)

__all__ = ["KERNELS", "dmf_fused_step", "dmf_fused_step_dp", "dmf_grads", "dp_clip_noise",
           "gauss_counter", "gossip_mix_op", "recommend_topk", "recommend_topk_peruser",
           "serve_topk", "serve_topk_rows", "serve_topk_tiled_quant", "serve_topk_window",
           "serve_topk_window_quant"]
