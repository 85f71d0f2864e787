"""Full SSD = the intra-chunk pieces (the CUDA kernel on CUDA tensors, the
plain version on CPU tensors and on nothing else) + the linear inter-chunk
recurrence, which stays plain PyTorch as it stays jnp around the Pallas
kernel (``repro/kernels/ssd_scan/ops.py``).

The kernel has no backward yet (the JAX package never differentiates its
Pallas SSD kernel either: it trains with ``use_pallas=False``). A call on
CUDA tensors that needs a gradient raises ``NotImplementedError`` rather
than return a tensor that would drop it; on CPU tensors the plain version
differentiates as it is."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import needs_grad
from repro_torch.kernels.ssd_scan.kernel import ssd_chunk_call as _kernel
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

NO_BACKWARD = ("the SSD chunk kernel has no backward yet: training the ssm "
               "and hybrid families on the card needs the SSD backward "
               "kernel of ROADMAP.md Queue 1, item 3")


def ssd(x, dt, A_log, B_, C_, D_, *, chunk: int = 256, state=None):
    """x: (B, S, nh, hp); dt: (B, S, nh) (post-softplus, fp32); A_log, D_:
    (nh,); B_/C_: (B, S, ns); state: (B, nh, hp, ns) or None.
    Returns (y (B, S, nh, hp) in x's dtype, final_state fp32)."""
    if x.device.type != "cpu" and needs_grad(x, dt, A_log, B_, C_, D_, state):
        raise NotImplementedError(NO_BACKWARD)
    B, S, nh, hp = x.shape
    ns = B_.shape[-1]
    cl = min(chunk, S)
    S_orig = S
    if S % cl:                 # pad with dt=0 tokens (state-neutral)
        pad = cl - S % cl
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        S = S + pad
    nc = S // cl

    pieces = ssd_chunk_ref if x.device.type == "cpu" else _kernel
    y_diag, states, exp_cs, exp_tot = pieces(x, dt, A_log.float(), B_, C_,
                                             chunk=chunk)

    if state is None:
        state = torch.zeros((B, nh, hp, ns), dtype=torch.float32,
                            device=x.device)
    C_c = C_.reshape(B, nc, cl, ns).float()
    y_off = []
    for c in range(nc):        # jax.lax.scan over the chunks
        y_off.append(torch.einsum("bin,bhpn,bih->bihp", C_c[:, c], state,
                                  exp_cs[:, c]))
        state = state * exp_tot[:, c, :, None, None] + states[:, c]
    y = (y_diag + torch.stack(y_off, dim=1)).reshape(B, S, nh, hp)
    y = y + x.float() * D_.float()[None, None, :, None]
    return y.to(x.dtype)[:, :S_orig], state
