"""A level-boundary conv composed with its FIR resample into one conv.

Same functions as ``r2dm_tpu/ops/fused_resample.py``. The U-Net's down path
runs ``downsample2x(ring_conv3x3(x))`` and its up path
``ring_conv3x3(upsample2x(h))``. Each pair is linear with nothing between,
so it composes into one convolution:

  down:  a stride-2 6x6 conv with C = F (x) F * K (the 3x3 kernel K
         convolved with the separable FIR window F): the FLOPs of the 3x3 at
         full resolution, with no full-resolution intermediate and no
         depthwise FIR pass;
  up:    Cu = K (*) F' (F' the upsampling window) applied to the
         zero-inserted input, run here polyphase: the four output phases
         (p, q) are 3x3 ring convs with Cu[1-p::2, 1-q::2], stacked on the
         output channels of one conv and interleaved by a reshape.

The W axis is a ring and composes exactly. On the H axis the two-op form
pads the intermediate with zeros, where the composition would read real
rows, so each op subtracts a one-row correction at the first and last
output row. The JAX module chooses among XLA lowerings of the up
composition (``UP_IMPL``: polyphase, dilated, H-polyphase); they compute the
same function, and the port has the polyphase one only.

Both are plain PyTorch (``F.conv2d``, cuDNN on the card), differentiable
in x, the kernel and the bias. The composed kernel is built in the kernel's
dtype in JAX's order (``_composed_kernel``), so in bfloat16 it rounds as
JAX's does. ``conv_then_downsample.calls`` / ``upsample_then_conv.calls``
count the calls, so a run can show which form its network took.

Under a width axis (``width``, as in ``ring_pad``) every W margin, of the
cells, of the edge rows and of the polyphase phases, comes from the
neighbouring ranks' columns; the compositions are shift-equivariant in W
(by 2 columns for the down one: a rank's W is even), so each rank's output
columns are those of the whole image's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.width import sharded
from .pad import ring_pad

FIR = tuple(v / 8.0 for v in (1.0, 3.0, 3.0, 1.0))  # the normalised window, exact in bf16
_WINDOWS: dict = {}


def _fir_window(dtype: torch.dtype, device) -> torch.Tensor:
    """``FIR`` as a tensor, made once per (dtype, device): one built from
    Python values on the card is a copy from the host, which blocks the
    host until the card is idle. Made outside inference mode, so autograd
    may save it."""
    key = (dtype, torch.device(device))
    if key not in _WINDOWS:
        with torch.inference_mode(False):
            _WINDOWS[key] = torch.tensor(FIR, dtype=dtype, device=device)
    return _WINDOWS[key]


def _composed_kernel(kernel: torch.Tensor, scale: float) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO -> (6, 6, Ci, Co): the full 2-D convolution of
    the kernel with the separable FIR window (``scale`` per axis), summed in
    the kernel's dtype with the H tap outer and the W tap inner, as JAX's
    ``.at[].add`` loop does."""
    f = _fir_window(kernel.dtype, kernel.device) * scale
    terms = (f[:, None] * f[None, :]).reshape(4, 4, 1, 1, 1, 1) * kernel  # (f[jh] f[jw]) K, each rounded once
    out = torch.zeros((6, 6) + tuple(kernel.shape[2:]), dtype=kernel.dtype, device=kernel.device)
    for jh in range(4):
        for jw in range(4):
            out[jh:jh + 3, jw:jw + 3] += terms[jh, jw]
    return out


class _ComposedKernel(torch.autograd.Function):
    """``_composed_kernel`` for autograd: the forward as built above, the
    backward one correlation of the cotangent with the FIR window's outer
    product, dK[a, b] = sum over (jh, jw) of f[jh] f[jw] dC[a + jh, b + jw],
    summed in fp32 and rounded once to the kernel's dtype (autograd through
    the loop would record 16 slice-adds and add their 16 cotangents one by
    one in that dtype)."""

    @staticmethod
    def forward(ctx, kernel: torch.Tensor, scale: float) -> torch.Tensor:
        ctx.scale = scale
        return _composed_kernel(kernel, scale)

    @staticmethod
    def backward(ctx, dc: torch.Tensor):
        f = _fir_window(torch.float32, dc.device) * ctx.scale
        Ci, Co = dc.shape[2:]
        dk = F.conv2d(dc.float().permute(2, 3, 0, 1).reshape(Ci * Co, 1, 6, 6), (f[:, None] * f[None, :])[None, None])
        return dk.reshape(Ci, Co, 3, 3).permute(2, 3, 0, 1).to(dc.dtype), None


def _row_composed_kernel(k_row: torch.Tensor, scale: float) -> torch.Tensor:
    """(3, Ci, Co) W kernel -> (1, 6, Ci, Co), FIR-composed along W."""
    f = _fir_window(k_row.dtype, k_row.device) * scale
    out = torch.zeros((6,) + tuple(k_row.shape[1:]), dtype=k_row.dtype, device=k_row.device)
    for jw in range(4):
        out[jw:jw + 3] += f[jw] * k_row
    return out[None]


def _conv(x: torch.Tensor, kernel_hwio: torch.Tensor, stride=1) -> torch.Tensor:
    """NHWC x (already padded) * HWIO kernel, valid, NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel_hwio.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    return y if bias is None else y + bias.to(y.dtype)


def _edge_corrections(y: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """y with ``top`` added to its first row and ``bottom`` to its last
    (both to the one row when y has one), each cast to y's dtype first."""
    y = y.contiguous()
    y[:, 0:1] += top.to(y.dtype)
    y[:, -1:] += bottom.to(y.dtype)
    return y


def _s2d_kernel(composed: torch.Tensor) -> torch.Tensor:
    """(6, 6, Ci, Co) -> the conv weight (Co, 4 Ci, 3, 3) on 2x2 cells
    (``_s2d_cells``): tap (2a + p, 2b + q) at (a, b), input channel block
    (p, q); channels-last strides, the layout cuDNN reads."""
    Ci, Co = composed.shape[2:]
    k = composed.reshape(3, 2, 3, 2, Ci, Co).permute(5, 0, 2, 1, 3, 4).reshape(Co, 3, 3, 4 * Ci)
    return k.contiguous().permute(0, 3, 1, 2)


def down_weight(kernel: torch.Tensor) -> torch.Tensor:
    """The conv weight ``conv_then_downsample`` applies, from the (3, 3,
    Ci, Co) HWIO kernel: the composed 6x6 kernel on 2x2 cells."""
    return _s2d_kernel(_ComposedKernel.apply(kernel, 1.0))


def _s2d_cells(x: torch.Tensor, width=None) -> torch.Tensor:
    """x (B, H, W, C), H and W even -> (B, H/2 + 2, W/2 + 2, 4 C): x's 2x2
    cells on the channels (row phase, column phase, channel), one cell of
    padding on each side, a ring in W and zeros in H, in one pass. Output
    cell o reads cells o - 1 .. o + 1, the rows and columns 2o - 2 .. 2o + 3
    of the composed taps, so a valid 3x3 conv gives exactly H/2 x W/2.
    Under a width axis the W cells of padding are the neighbours' edge
    cells."""
    B, H, W, C = x.shape
    Hs, Ws = H // 2, W // 2
    out = x.new_zeros(B, Hs + 2, Ws + 2, 2, 2, C)
    if sharded(width):
        xw = ring_pad(x, (2, 2, 0, 0), width=width)  # one cell of each neighbour's
        out[:, 1:Hs + 1] = xw.reshape(B, Hs, 2, Ws + 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return out.reshape(B, Hs + 2, Ws + 2, 4 * C)
    cells = x.reshape(B, Hs, 2, Ws, 2, C).permute(0, 1, 3, 2, 4, 5)
    out[:, 1:Hs + 1, 1:Ws + 1] = cells
    out[:, 1:Hs + 1, 0] = cells[:, :, Ws - 1]  # the ring: x's last cell on the left,
    out[:, 1:Hs + 1, Ws + 1] = cells[:, :, 0]  # its first on the right
    return out.reshape(B, Hs + 2, Ws + 2, 4 * C)


def _cells_matmul(cells: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The valid 3x3 conv of the padded cells (B, Hs + 2, Ws + 2, 4 Ci)
    with ``weight`` (Co, 4 Ci, 3, 3) as im2col and a matrix product: (B,
    Hs, Ws, Co)."""
    B, Hp, Wp, C4 = cells.shape
    cols = cells.unfold(1, 3, 1).unfold(2, 3, 1)  # (B, Hs, Ws, 4 Ci, 3, 3)
    cols = cols.permute(0, 1, 2, 4, 5, 3).reshape(B * (Hp - 2) * (Wp - 2), 9 * C4)
    return (cols @ weight.permute(2, 3, 1, 0).reshape(9 * C4, -1)).view(B, Hp - 2, Wp - 2, -1)


def _cells_cudnn(cells: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The same conv as cuDNN's 3x3 conv, one sample a call: every sample
    then goes through the same call at the same shape, so its result does
    not depend on its row in the batch or on the batch size. One cuDNN
    conv over the whole batch gave a sample other sums in some rows (at
    d_block3 and d_block4, at batches from 4 to 512; on an H100 80GB HBM3:
    ``fused_resample_variants.py``), which a data-parallel run that strides
    the seeds over ranks sees as other samples."""
    return torch.cat([F.conv2d(c.permute(0, 3, 1, 2), weight).permute(0, 2, 3, 1) for c in cells.split(1)])


def _cells_conv(cells: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The valid 3x3 conv of the padded cells: on the card cuDNN's conv,
    one sample a call; on the CPU one matrix product of the im2col
    patches, whose sums land nearer JAX's CPU conv on the ill-conditioned
    first step of a sampling chain than the CPU conv's do
    (``tests/test_torch_port_sampling.py``)."""
    return _cells_cudnn(cells, weight) if cells.is_cuda else _cells_matmul(cells, weight)


def conv_then_downsample(
    x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor], weight: Optional[torch.Tensor] = None,
    width=None,
) -> torch.Tensor:
    """== downsample2x(ring_conv3x3(x, kernel) + bias), as one conv.

    x (B, H, W, Ci) NHWC with H, W even and W >= 6; ``kernel`` (3, 3, Ci,
    Co) HWIO in x's dtype; ``weight``: ``down_weight(kernel)`` where the
    caller keeps it. Per axis the composed 6-tap kernel reads x[2o-2 ..
    2o+3]: a wrap pad of (2, 3) on W, a zero pad of (2, 3) on H, stride 2.
    It runs as the same sums over x's 2x2 cells: a stride-1 3x3 conv with 4
    Ci input channels, one sample a call on the card (``_cells_conv``;
    cuDNN's stride-2 6x6 conv over the batch took 2.70 ms at d_block4's
    shape, b8, against 0.26 for this form on an H100:
    ``fused_resample_variants.py``). The FIR's
    zero margin removes z[-1] and z[H] of z = K*x + b, which the
    composition derives from x[0] and x[H-1] through K's own zero padding:
    subtract f[0] and f[3] times those single-row convs, FIR-downsampled
    along W (the two rows as the two groups of one conv). ``width``: as in
    ``ring_pad`` (a rank's W may then be as small as 2)."""
    B, H, W, Ci = x.shape
    assert H % 2 == 0 and W % 2 == 0 and (W >= 6 or sharded(width)), (H, W)
    Co = kernel.shape[-1]
    conv_then_downsample.calls += 1
    weight = down_weight(kernel) if weight is None else weight
    y = _add_bias(_cells_conv(_s2d_cells(x, width), weight), bias)
    # z_row of x[:, 0] with K's last row and of x[:, H-1] with its first
    rows = torch.cat([x[:, 0:1], x[:, H - 1:H]], dim=-1)  # (B, 1, W, 2 Ci)
    k_rows = torch.cat([kernel[2], kernel[0]], dim=-1).permute(2, 1, 0)[:, :, None]  # (2 Co, Ci, 1, 3)
    z = F.conv2d(ring_pad(rows, (1, 1, 0, 0), width=width).permute(0, 3, 1, 2), k_rows, groups=2)
    if bias is not None:
        z = z + torch.cat([bias, bias]).to(z.dtype)[:, None, None]
    # fir_w_down: (B, 2 Co, 1, W) -> (B, 2 Co, 1, W/2), ring
    fir = _fir_window(z.dtype, z.device).reshape(1, 1, 1, 4).expand(2 * Co, 1, 1, 4)
    z = F.conv2d(ring_pad(z.permute(0, 2, 3, 1), (1, 2, 0, 0), width=width).permute(0, 3, 1, 2), fir, stride=(1, 2),
                 groups=2 * Co).permute(0, 2, 3, 1)
    return _edge_corrections(y, -FIR[0] * z[..., :Co].float(), -FIR[3] * z[..., Co:].float())


def _polyphase_ring_conv(x: torch.Tensor, kernel6: torch.Tensor, h_phases: bool, width=None) -> torch.Tensor:
    """The composed up kernel (6 or 1, 6, Ci, Co) on the zero-inserted x,
    as one 3-tap ring conv per output phase: the phases stacked on the
    output channels, then interleaved into (B, 2H or H, 2W, Co). H is
    zero-padded by one when ``h_phases``."""
    B, H, W, _ = x.shape
    Co = kernel6.shape[-1]
    ph = (0, 1) if h_phases else (None,)
    subs = [kernel6[1 - p::2, 1 - q::2] if p is not None else kernel6[:, 1 - q::2] for p in ph for q in (0, 1)]
    y = _conv(ring_pad(x, (1, 1, 1, 1) if h_phases else (1, 1, 0, 0), width=width), torch.cat(subs, dim=-1))
    P = len(ph)
    # out[P t + p, 2 w + q] = phase (p, q) at (t, w)
    y = y.reshape(B, H, W, P, 2, Co).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, P * H, 2 * W, Co)


def upsample_then_conv(h: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor], width=None) -> torch.Tensor:
    """== ring_conv3x3(upsample2x(h), kernel) + bias, composed and run
    polyphase. The outer conv zero-pads u = upsample2x(h) at rows -1 and
    2H, where the composition computes u[-1] = 2 f[3] Wup(h[0]) and u[2H] =
    2 f[0] Wup(h[H-1]): subtract those single rows through K's edge rows."""
    B, H, W, Ci = h.shape
    upsample_then_conv.calls += 1
    y = _add_bias(_polyphase_ring_conv(h, _ComposedKernel.apply(kernel, 2.0), h_phases=True, width=width), bias)

    def w_comp_row(row, k_row):  # (B, 1, W, Ci) -> (B, 1, 2W, Co), ring
        return _polyphase_ring_conv(row, _row_composed_kernel(k_row, 2.0), h_phases=False, width=width)

    top = -(w_comp_row(h[:, 0:1], kernel[0]).float() * (2.0 * FIR[3]))
    bottom = -(w_comp_row(h[:, H - 1:H], kernel[2]).float() * (2.0 * FIR[0]))
    return _edge_corrections(y, top, bottom)


conv_then_downsample.calls = 0
upsample_then_conv.calls = 0
