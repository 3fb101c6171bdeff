"""Float32 products at float32 accuracy on Hopper's tensor cores (3xTF32).

The float32 WavLM trunk's linears and strided feature-extractor convs
(``models/blocks/ssl.py``) go through ``linears`` and ``strided_conv``.
Each is ``x . W^T + bias`` (GELU optional) over rows of ``x``; the route is
a pure function of what the call can observe (``route``):

- autograd needs a graph (grad enabled and an input that requires it):
  the torch ops (``F.linear``, ``F.conv1d``), counted in
  ``tf32x3_gemm.torch_calls`` (on the card an inference file counts 0);
  an input that is not float32 takes them too, uncounted;
- a CPU tensor: the plain version (``tf32x3_matmul_plain``);
- a CUDA tensor: the hand-written kernel ``csrc/tf32x3_gemm.cu`` (see the
  source for its design), counted in ``tf32x3_gemm.launches``. There is
  no fallback: a shape the kernel does not take raises.

Both the plain version and the kernel split each operand into hi (rounded
to TF32, nearest, ties away from zero) and lo (the rest, rounded to TF32)
and sum lo_A.hi_W + hi_A.lo_W + hi_A.hi_W in float32: about 2^-21 of each
product is dropped, so the result is as accurate as a float32 product.
That is the port's counterpart of the JAX package's float32 products,
which XLA runs at HIGHEST as passes of the TPU's matrix unit; TF32 stays
off for every library call (``utils.runtime.exact_float32``).

W is split once and cached on the module that owns it (plain hi and lo
for the CPU, ``pack_weight``'s layout for the kernel), rebuilt when a
weight's ``_version`` or storage changes (an in-place update, a new
device); the concatenated q, k, v weight of an attention layer is one
cached W.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

TILE_N = 128   # W's rows per packed tile: the kernel's wgmma n
TILE_K = 32    # W's columns per k-block: 128 bytes, one swizzled row
SWIZZLE = 8    # 16-byte chunks in a 128-byte row, rotated by row % 8


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits: nearest, ties
    away from zero, by integer arithmetic on the bits (the kernel's)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = x rounded to TF32, lo = (x - hi) rounded to TF32."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_matmul_plain(a: torch.Tensor, w_hi: torch.Tensor,
                        w_lo: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        gelu: bool = False) -> torch.Tensor:
    """(..., K) x (N, K) split weights -> (..., N): the kernel's
    arithmetic, ``lo_A.hi_W + hi_A.lo_W + hi_A.hi_W`` in float32, then the
    bias and the exact GELU."""
    a_hi, a_lo = split_tf32(a)
    out = torch.matmul(a_lo, w_hi.T) + torch.matmul(a_hi, w_lo.T)
    out = out + torch.matmul(a_hi, w_hi.T)
    if bias is not None:
        out = out + bias
    return F.gelu(out) if gelu else out


def _column_order() -> torch.Tensor:
    """Column of a 32-column k-block (physical, as A holds it) that the
    kernel's logical column L = 8 j + c (k-step j, fragment column c)
    reads. A thread t of a warp loads physical columns [4t, 4t + 4) and
    [16 + 4t, 16 + 4t + 4) of a row, its values q = 0..7, and gives k-step
    j its values 2j (fragment column t) and 2j + 1 (column t + 4)."""
    order = []
    for logical in range(TILE_K):
        j, c = divmod(logical, 8)
        t, q = c % 4, 2 * j + c // 4
        order.append(4 * t + q if q < 4 else 16 + 4 * t + q - 4)
    return torch.tensor(order)


def _swizzled(rows: int) -> torch.Tensor:
    """(rows, 8): the logical 16-byte chunk that row r holds at each
    physical chunk (the 128-byte swizzle: chunk c ^ (r % 8))."""
    return torch.arange(SWIZZLE)[None, :] ^ (torch.arange(rows)[:, None]
                                             % SWIZZLE)


def pack_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, K) float32 -> (hi, lo), each the kernel's layout on w's device:
    N padded to a multiple of TILE_N and K to one of TILE_K with zeros,
    then for each (row tile, k-block) one contiguous (TILE_N, TILE_K)
    block whose columns follow ``_column_order`` and whose 16-byte chunks
    are swizzled: shape (N / TILE_N, K / TILE_K, TILE_N, TILE_K)."""
    N, K = w.shape
    Np, Kp = -(-N // TILE_N) * TILE_N, -(-K // TILE_K) * TILE_K
    padded = w.new_zeros(Np, Kp, dtype=torch.float32)
    padded[:N, :K] = w
    order = _column_order().to(w.device)
    chunks = _swizzled(TILE_N).to(w.device)
    packed = []
    for part in split_tf32(padded):
        blocks = part.reshape(Np // TILE_N, TILE_N, Kp // TILE_K, TILE_K)
        blocks = blocks[..., order].reshape(
            Np // TILE_N, TILE_N, Kp // TILE_K, SWIZZLE, 4)
        index = chunks[None, :, None, :, None].expand_as(blocks)
        blocks = torch.gather(blocks, 3, index)
        packed.append(blocks.permute(0, 2, 1, 3, 4).reshape(
            Np // TILE_N, Kp // TILE_K, TILE_N, TILE_K).contiguous())
    return packed[0], packed[1]


def route(x: torch.Tensor, *params: Optional[torch.Tensor]) -> str:
    """The route of a product of x: "torch" where autograd needs a graph
    or x is not float32, else "plain" on the CPU, "kernel" on a card."""
    if x.dtype != torch.float32 or (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x,) + params)):
        return "torch"
    return "kernel" if x.is_cuda else "plain"


def _bind() -> ctypes.CDLL:
    from ..utils.build import load
    lib = load("tf32x3_gemm")
    fn = lib.tf32x3_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
            [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


class Tf32x3Gemm(torch.autograd.Function):
    """A launch of the kernel as a torch op of this name: the profiler
    links each kernel to the op that launched it (what the benchmark's
    per-layer device times read), and a ctypes launch has no op of its
    own. Nothing is differentiated: the kernel's route needs no graph."""

    @staticmethod
    def forward(ctx, out: torch.Tensor, launch) -> torch.Tensor:
        with torch.cuda.device(out.device):
            err = launch()
        if err != 0:
            raise RuntimeError(f"tf32x3_gemm launch failed with CUDA error "
                               f"{err}")
        return out


def tf32x3_gemm(a: torch.Tensor, w_hi: torch.Tensor, w_lo: torch.Tensor,
                n: int, k: int, rows: int, row_stride: int,
                bias: Optional[torch.Tensor] = None,
                gelu: bool = False) -> torch.Tensor:
    """One launch of the kernel -> (items, rows, n) float32.

    ``a`` (items, ...) float32 on a CUDA device: row r of item b holds the
    ``k`` contiguous floats at ``a[b]``'s start + r * ``row_stride``
    (``linear_rows``, ``conv_rows``); ``w_hi``, ``w_lo`` are
    ``pack_weight`` of an (n, k) weight. Counted in ``.launches``; raises
    on what the kernel does not take (k, the strides and A's start must
    be multiples of 4 floats, every row inside A's storage).
    """
    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"the 3xTF32 kernel takes float32 on a CUDA "
                         f"device, got {a.dtype} on {a.device}")
    items = a.shape[0]
    last = (items - 1) * a.stride(0) + (rows - 1) * row_stride + k
    if (min(n, k, rows, items) < 1 or k % 4 or row_stride % 4
            or a.stride(0) % 4 or a.data_ptr() % 16 or last
            > a.untyped_storage().nbytes() // 4 - a.storage_offset()):
        raise ValueError(f"the 3xTF32 kernel takes K ({k}), the strides "
                         f"({row_stride}, {a.stride(0)}) and A's start as "
                         f"multiples of 4 floats, every row inside A")
    for part in (w_hi, w_lo):
        if (part.device != a.device or part.dtype != torch.float32
                or part.dim() != 4 or not part.is_contiguous()
                or part.shape[2:] != (TILE_N, TILE_K)
                or part.shape[0] != -(-n // TILE_N)
                or part.shape[1] != -(-k // TILE_K)):
            raise ValueError(f"packed W {tuple(part.shape)} on "
                             f"{part.device} is not for N={n}, K={k}")
    if bias is not None and (tuple(bias.shape) != (n,) or bias.dtype
                             != torch.float32 or bias.device != a.device
                             or not bias.is_contiguous()):
        raise ValueError(f"bias must be ({n},) float32 on {a.device}")
    out = torch.empty((items, rows, n), device=a.device,
                      dtype=torch.float32)
    Tf32x3Gemm.apply(out, lambda: _bind().tf32x3_gemm(
        a.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(),
        items * rows, n, k, rows, a.stride(0), row_stride, int(gelu),
        torch.cuda.current_stream(a.device).cuda_stream))
    tf32x3_gemm.launches += 1
    return out


tf32x3_gemm.launches = 0
tf32x3_gemm.torch_calls = 0


def linear_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """(A, rows, row stride, K) of a linear's input (..., K): a 3-D input
    keeps its strides where its last is 1, anything else is flattened to
    one item of rows."""
    if x.dim() != 3 or x.stride(-1) != 1:
        x = x.reshape(1, -1, x.shape[-1])
        if x.stride(-1) != 1:
            x = x.contiguous()
    return x, x.shape[1], x.stride(1), x.shape[2]


def conv_rows(x: torch.Tensor, kernel: int, stride: int
              ) -> Tuple[torch.Tensor, int, int, int]:
    """(A, rows, row stride, K) of a strided conv over channels-last
    (B, T, C): output frame t reads x[b, t * stride : t * stride + kernel,
    :], one contiguous run of K = kernel * C floats."""
    x = x.contiguous()
    _, T, C = x.shape
    if T < kernel:
        raise ValueError(f"{T} frames are fewer than the kernel's {kernel}")
    return x, (T - kernel) // stride + 1, stride * C, kernel * C


def conv_view(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """``conv_rows`` as a (B, T', kernel * C) view of x (overlapping rows:
    nothing is copied)."""
    x, rows, row_stride, k = conv_rows(x, kernel, stride)
    return x.as_strided((x.shape[0], rows, k), (x.stride(0), row_stride, 1))


def _split_weight(owner: nn.Module, sources: Sequence[torch.Tensor],
                  matrix, bias, kernel: bool) -> tuple:
    """(hi, lo, bias) of the (N, K) weight ``matrix()`` and bias
    ``bias()``: ``pack_weight``'s parts for the kernel, else plain split
    parts; cached on ``owner`` and rebuilt when a source tensor's version,
    storage or device changes."""
    key = (kernel,) + tuple((t.device, t.data_ptr(), t._version)
                            for t in sources)
    cached = owner.__dict__.get("_tf32x3_weight")
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        w = matrix()
        hi, lo = pack_weight(w) if kernel else split_tf32(w)
        b = bias()
        value = (hi, lo, None if b is None else b.contiguous())
    owner.__dict__["_tf32x3_weight"] = (key, value)
    return value


def linears(x: torch.Tensor, layers: Sequence[nn.Linear],
            gelu: bool = False) -> Tuple[torch.Tensor, ...]:
    """Each layer of ``layers`` (one input width, all biased or none)
    applied to x (..., K), GELU after each where asked: on the kernel and
    plain routes one product over their concatenated weights (q, k and v
    in one), on the torch route each layer as it is."""
    params = [t for layer in layers for t in (layer.weight, layer.bias)
              if t is not None]
    how = route(x, *params)
    if how == "torch":
        if x.dtype == torch.float32:
            tf32x3_gemm.torch_calls += 1
        outs = tuple(layer(x) for layer in layers)
        return tuple(F.gelu(o) for o in outs) if gelu else outs

    hi, lo, b = _split_weight(
        layers[0], params,
        lambda: torch.cat([layer.weight for layer in layers]),
        lambda: None if layers[0].bias is None else torch.cat(
            [layer.bias for layer in layers]), how == "kernel")
    n = sum(layer.out_features for layer in layers)
    if how == "plain":
        out = tf32x3_matmul_plain(x, hi, lo, b, gelu)
    else:
        a, rows, row_stride, k = linear_rows(x)
        out = tf32x3_gemm(a, hi, lo, n, k, rows, row_stride, b, gelu)
        out = out.reshape(*x.shape[:-1], n)
    return tuple(out.split([layer.out_features for layer in layers], -1))


def linear(x: torch.Tensor, layer: nn.Linear,
           gelu: bool = False) -> torch.Tensor:
    """``linears`` of one layer."""
    return linears(x, (layer,), gelu)[0]


def strided_conv(x: torch.Tensor, conv: nn.Conv1d,
                 gelu: bool = False) -> torch.Tensor:
    """``conv`` (no padding, dilation or groups) over channels-last
    (B, T, C_in) -> channels-last (B, T', C_out), GELU after where asked;
    the torch route runs ``F.conv1d`` on the transposed view."""
    if (conv.padding != (0,) or conv.dilation != (1,) or conv.groups != 1
            or x.dim() != 3 or x.shape[-1] != conv.in_channels):
        raise ValueError(f"strided_conv takes an unpadded, undilated, "
                         f"ungrouped conv over (B, T, {conv.in_channels})")
    kernel, stride = conv.kernel_size[0], conv.stride[0]
    how = route(x, conv.weight, conv.bias)
    if how == "torch":
        if x.dtype == torch.float32:
            tf32x3_gemm.torch_calls += 1
        out = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                       stride).transpose(1, 2)
        return F.gelu(out) if gelu else out
    sources = [t for t in (conv.weight, conv.bias) if t is not None]
    hi, lo, b = _split_weight(
        conv, sources,
        lambda: conv.weight.permute(0, 2, 1).reshape(conv.out_channels, -1),
        lambda: conv.bias, how == "kernel")
    if how == "plain":
        return tf32x3_matmul_plain(conv_view(x, kernel, stride), hi, lo, b,
                                   gelu)
    a, rows, row_stride, k = conv_rows(x, kernel, stride)
    return tf32x3_gemm(a, hi, lo, conv.out_channels, k, rows, row_stride, b,
                       gelu)
