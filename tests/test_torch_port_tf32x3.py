"""The 3xTF32 products of the port's float32 SSL trunk (``ops/tf32x3_gemm.py``).

On the CPU: the strided conv-as-GEMM view against ``F.conv1d`` in float64
at every feature-extractor conv of both trunk kinds; the plain version
against a float64 product; the kernel's weight packing (its fragment
mapping emulated in float64); the dispatch rule; the split-weight cache;
the trunk's routes against each other. On a CUDA card (``cuda`` marker,
skipped without one): the kernel against a float64 product at the trunk's
shapes, next to ``torch.matmul`` in float32 with TF32 off, and a WavLM-base
forward on its kernel route against its torch route, at ``ssl_gap``'s
limit (1e-4 relative L2 a frame). This file imports no JAX: the SSL trunk's
parity with the JAX package is ``test_torch_port_ssl.py``'s.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from pyannote_audio_tpu_torch.models.blocks.ssl import (CONV_KERNELS,
                                                        CONV_STRIDES,
                                                        SSLEncoder)
from pyannote_audio_tpu_torch.ops import tf32x3_gemm as tf32x3
from pyannote_audio_tpu_torch.ops.tf32x3_gemm import (
    TILE_K, TILE_N, conv_view, linear, linears, pack_weight, route,
    split_tf32, strided_conv, tf32x3_matmul_plain)
from pyannote_audio_tpu_torch.utils.runtime import exact_float32

# the plain version's bound against a float64 product, elementwise, as a
# share of |A|.|W|^T: 16 float32 roundings. What the split drops (lo.lo,
# lo rounded to TF32) is under 2^-21 of each product, and float32 sums of
# random signs stay within a few roundings at the trunk's K (measured: at
# most 4.3 on these inputs, torch.matmul's 3.0)
PLAIN_BOUND = 2.0 ** -20

# both trunk kinds' convs 1-6: (kernel, stride, bias); LARGE's are biased
CONVS = [(k, s, bias) for bias in (False, True)
         for k, s in zip(CONV_KERNELS[1:], CONV_STRIDES[1:])]

TINY = dict(hidden=32, layers=2, heads=4, ffn=64, conv_channels=16)
TRUNKS = {
    "base": dict(TINY, rel_pos_bias=True, pre_ln=False, conv_norm="group"),
    "large": dict(TINY, rel_pos_bias=False, pre_ln=True, conv_norm="layer"),
}


@pytest.mark.parametrize("frames", [37, 38])
@pytest.mark.parametrize("kernel,stride,bias", CONVS)
def test_conv_view_equals_conv1d_in_float64(kernel, stride, bias, frames):
    """Output frame t of a strided conv over channels-last (B, T, C) is
    the contiguous run x[b, t s : t s + k, :] times the weight permuted to
    (C_out, k C_in): exact in float64, odd and even input lengths."""
    g = torch.Generator().manual_seed(frames + kernel)
    x = torch.randn(2, frames, 512, generator=g, dtype=torch.float64)
    w = torch.randn(512, 512, kernel, generator=g, dtype=torch.float64)
    b = torch.randn(512, generator=g, dtype=torch.float64) if bias else None
    ours = conv_view(x, kernel, stride) @ w.permute(0, 2, 1).reshape(
        512, -1).T
    if bias:
        ours = ours + b
    expected = F.conv1d(x.transpose(1, 2), w, b, stride).transpose(1, 2)
    assert ours.shape == expected.shape == (2, (frames - kernel) // stride
                                            + 1, 512)
    torch.testing.assert_close(ours, expected, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("M,N,K", [(64, 2304, 768), (64, 768, 3072),
                                   (64, 512, 1536), (17, 10, 4),
                                   (33, 300, 100)])
def test_plain_version_within_its_bound_of_float64(M, N, K):
    g = torch.Generator().manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g) / math.sqrt(K)
    bias = torch.randn(N, generator=g)
    expected = a.double() @ w.double().T + bias.double()
    scale = a.double().abs() @ w.double().abs().T
    ours = tf32x3_matmul_plain(a, *split_tf32(w), bias)
    assert ours.dtype == torch.float32
    assert ((ours.double() - expected).abs() / scale).max() <= PLAIN_BOUND
    # and a single TF32 pass is far outside it
    hi_only = tf32x3.tf32_round(a) @ tf32x3.tf32_round(w).T + bias
    assert ((hi_only.double() - expected).abs() / scale).max() \
        > 16 * PLAIN_BOUND


def test_split_is_exact_to_its_rounding():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = split_tf32(x)
    assert (hi.view(torch.int32) & 0x1fff).eq(0).all()
    assert (lo.view(torch.int32) & 0x1fff).eq(0).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all()
    assert ((hi - x).abs() <= x.abs() * 2.0 ** -11).all()


def unpack_weight(packed: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """The inverse of one part of ``pack_weight``: (N, K)."""
    nt, kb = packed.shape[:2]
    blocks = packed.reshape(nt, kb, TILE_N, 8, 4)
    rows = torch.arange(TILE_N)[:, None] % 8
    index = (torch.arange(8)[None, :] ^ rows)[None, None, :, :, None]
    blocks = torch.gather(blocks, 3, index.expand_as(blocks))
    blocks = blocks.reshape(nt, kb, TILE_N, TILE_K)
    out = torch.empty_like(blocks)
    out[..., tf32x3._column_order()] = blocks
    return out.permute(0, 2, 1, 3).reshape(nt * TILE_N, kb * TILE_K)[:N, :K]


@pytest.mark.parametrize("N,K", [(300, 96), (768, 1536), (5, 4)])
def test_pack_weight_is_what_the_kernel_reads(N, K):
    """``pack_weight``'s blocks, read as the kernel reads them (wgmma's
    B from the swizzled rows, k-step j at 32 bytes a step; A's fragment
    from a thread's two 16-byte loads), give A . hi^T; unpacking gives the
    split back."""
    g = torch.Generator().manual_seed(N)
    w = torch.randn(N, K, generator=g)
    hi, lo = pack_weight(w)
    assert hi.shape == lo.shape == (-(-N // TILE_N), -(-K // 32), TILE_N,
                                    32)
    expected_hi, expected_lo = split_tf32(w)
    assert torch.equal(unpack_weight(hi, N, K), expected_hi)
    assert torch.equal(unpack_weight(lo, N, K), expected_lo)
    a = torch.randn(8, K, generator=g, dtype=torch.float64)
    n = torch.arange(TILE_N)
    acc = torch.zeros(8, hi.shape[0] * TILE_N, dtype=torch.float64)
    for nt in range(hi.shape[0]):
        for kb in range(hi.shape[1]):
            block = hi[nt, kb].double()
            for j in range(4):
                for c in range(8):
                    t, q = c % 4, 2 * j + c // 4
                    col = kb * 32 + (4 * t + q if q < 4
                                     else 16 + 4 * t + q - 4)
                    if col >= K:
                        continue
                    logical = 8 * j + c
                    b = block[n, ((logical // 4) ^ (n % 8)) * 4
                              + logical % 4]
                    acc[:, nt * TILE_N:(nt + 1) * TILE_N] += \
                        a[:, col, None] * b
    torch.testing.assert_close(acc[:, :N], a @ expected_hi.double().T,
                               rtol=1e-12, atol=1e-12)


def test_route_is_what_the_call_observes():
    layer = nn.Linear(8, 4)
    x = torch.randn(3, 8)
    assert route(x, layer.weight, layer.bias) == "torch"  # grad enabled
    with torch.no_grad():
        assert route(x, layer.weight, layer.bias) == "plain"
    with torch.inference_mode():
        assert route(x, layer.weight, layer.bias) == "plain"
    layer.requires_grad_(False)
    assert route(x, layer.weight, layer.bias) == "plain"
    assert route(x.requires_grad_(), layer.weight) == "torch"
    with torch.no_grad():
        assert route(x.double(), layer.weight) == "torch"


def test_a_needed_graph_takes_torch_and_is_counted():
    layer = nn.Linear(8, 4)
    x = torch.randn(3, 8)
    calls = tf32x3.tf32x3_gemm.torch_calls
    launches = tf32x3.tf32x3_gemm.launches
    out = linear(x, layer, gelu=True)
    assert out.requires_grad
    torch.testing.assert_close(out, F.gelu(layer(x)), rtol=0, atol=0)
    assert tf32x3.tf32x3_gemm.torch_calls == calls + 1
    with torch.no_grad():
        plain = linear(x, layer, gelu=True)
    assert not plain.requires_grad
    assert tf32x3.tf32x3_gemm.torch_calls == calls + 1
    torch.testing.assert_close(plain, out.detach(), rtol=1e-6, atol=1e-6)
    assert tf32x3.tf32x3_gemm.launches == launches


def test_conv0_and_the_positional_conv_stay_conv1d(monkeypatch):
    """Without a graph only conv 0 and the grouped positional conv call
    ``F.conv1d``; with one, convs 1-6 do too (the torch route)."""
    calls = []
    conv1d = F.conv1d

    def counted(x, weight, *args, **kwargs):
        calls.append(tuple(weight.shape))
        return conv1d(x, weight, *args, **kwargs)

    monkeypatch.setattr(F, "conv1d", counted)
    encoder = SSLEncoder(**TRUNKS["base"]).eval()
    wav = torch.randn(1, 4000, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        encoder(wav)
    assert calls == [(16, 1, 10), (32, 2, 128)]
    calls.clear()
    torch_calls = tf32x3.tf32x3_gemm.torch_calls
    encoder(wav)
    assert calls == [(16, 1, 10)] + [(16, 16, k) for k in CONV_KERNELS[1:]] \
        + [(32, 2, 128)]
    # 6 convs, the projection and 4 products in each of 2 layers
    assert tf32x3.tf32x3_gemm.torch_calls == torch_calls + 6 + 1 + 2 * 4


def test_split_weight_cache_follows_in_place_updates():
    g = torch.Generator().manual_seed(2)
    q, k, v = (nn.Linear(8, 8) for _ in range(3))
    conv = nn.Conv1d(8, 6, 3, stride=2)
    x = torch.randn(2, 9, 8, generator=g)
    with torch.no_grad():
        before = linears(x, (q, k, v))
        cached = q.__dict__["_tf32x3_weight"][1]
        assert linears(x, (q, k, v))[0] is not before[0]
        assert q.__dict__["_tf32x3_weight"][1] is cached
        k.weight.mul_(2)
        v.bias.add_(1)
        after = linears(x, (q, k, v))
        assert q.__dict__["_tf32x3_weight"][1] is not cached
        for ours, layer in zip(after, (q, k, v)):
            torch.testing.assert_close(ours, layer(x), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(after[0], before[0], rtol=0, atol=0)
        first = strided_conv(x, conv)
        conv.weight.mul_(-1)
        second = strided_conv(x, conv)
        expected = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                            2).transpose(1, 2)
        torch.testing.assert_close(second, expected, rtol=1e-6, atol=1e-6)
        assert not torch.allclose(first, second)


@pytest.mark.parametrize("kind", sorted(TRUNKS))
def test_trunk_routes_agree(kind):
    """The trunk without a graph (the plain 3xTF32 route, channels-last
    feature extractor) against its torch route (a graph needed)."""
    encoder = SSLEncoder(**TRUNKS[kind],
                         generator=torch.Generator().manual_seed(3)).eval()
    wav = torch.randn(2, 8001, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        plain = encoder(wav)
    graph = encoder(wav)
    assert graph[-1].requires_grad
    for ours, theirs in zip(plain, graph):
        assert ours.shape == theirs.shape
        torch.testing.assert_close(ours, theirs.detach(), rtol=1e-5,
                                   atol=1e-5)


# -- on the card ---------------------------------------------------------------

# the trunk's linears at one segmentation batch (32 chunks x 499 frames):
# (M, N, K); the convs: (items, input frames, kernel, stride)
CARD_LINEARS = [(15968, 2304, 768), (15968, 768, 768), (15968, 3072, 768),
                (15968, 768, 3072), (15968, 768, 512), (1001, 300, 100),
                (7, 10, 4), (129, 257, 36)]
CARD_CONVS = [(32, 31999, 3, 2), (32, 1999, 2, 2), (3, 17, 3, 2)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _relative(ours: torch.Tensor, expected: torch.Tensor) -> float:
    return ((ours.double() - expected).abs().max()
            / expected.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("M,N,K", CARD_LINEARS)
def test_kernel_linear_against_float64(M, N, K, gelu):
    """Within 4x torch.matmul's float32 error (TF32 off) of a float64
    product, normwise; one launch."""
    device = _card()
    g = torch.Generator(device=device).manual_seed(M + N + K)
    a = torch.randn(M, K, generator=g, device=device)
    w = torch.randn(N, K, generator=g, device=device) / math.sqrt(K)
    bias = torch.randn(N, generator=g, device=device)
    layer = nn.Linear(K, N).to(device)
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(bias)
    expected = a.double() @ w.double().T + bias.double()
    with exact_float32():
        library = a @ w.T + bias
    if gelu:
        expected, library = F.gelu(expected), F.gelu(library)
    launches = tf32x3.tf32x3_gemm.launches
    with torch.inference_mode():
        ours = linear(a, layer, gelu)
    torch.cuda.synchronize()
    assert tf32x3.tf32x3_gemm.launches == launches + 1
    assert ours.shape == (M, N)
    assert _relative(ours, expected) <= 4 * _relative(library, expected)


@pytest.mark.cuda
@pytest.mark.parametrize("items,frames,kernel,stride", CARD_CONVS)
def test_kernel_conv_against_float64(items, frames, kernel, stride):
    """A feature-extractor conv (512 channels, channels-last) with GELU
    fused, its rows read in place: within 4x torch.matmul's float32 error
    over the same rows."""
    device = _card()
    g = torch.Generator(device=device).manual_seed(frames)
    x = torch.randn(items, frames, 512, generator=g, device=device)
    conv = nn.Conv1d(512, 512, kernel, stride=stride, bias=False).to(device)
    w = conv.weight.detach().permute(0, 2, 1).reshape(512, -1)
    expected = F.gelu(conv_view(x.double(), kernel, stride) @ w.double().T)
    with exact_float32():
        library = F.gelu(conv_view(x, kernel, stride) @ w.T)
    launches = tf32x3.tf32x3_gemm.launches
    with torch.inference_mode():
        ours = strided_conv(x, conv, gelu=True)
    torch.cuda.synchronize()
    assert tf32x3.tf32x3_gemm.launches == launches + 1
    assert ours.shape == expected.shape
    assert _relative(ours, expected) <= 4 * _relative(library, expected)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    device = _card()
    a = torch.zeros(1, 8, 6, device=device)
    hi, lo = pack_weight(torch.zeros(4, 6, device=device))
    launches = tf32x3.tf32x3_gemm.launches
    with pytest.raises(ValueError, match="multiples of 4"):
        tf32x3.tf32x3_gemm(a, hi, lo, 4, 6, 8, 6)
    assert tf32x3.tf32x3_gemm.launches == launches


@pytest.mark.cuda
def test_wavlm_base_on_card_matches_its_torch_route():
    """WavLM-base (12 x 768) on two 10-s chunks: every state of the kernel
    route within 1e-4 relative L2 a frame (``ssl_gap``'s limit) of the
    torch route (float32 with TF32 off); 55 launches (6 convs, the
    projection, 4 products in each of 12 layers) and no torch call."""
    device = _card()
    encoder = SSLEncoder(hidden=768, layers=12, heads=12, ffn=3072,
                         rel_pos_bias=True, pre_ln=False, conv_norm="group",
                         normalize_last=False,
                         generator=torch.Generator().manual_seed(5))
    encoder = encoder.to(device).eval()
    wav = torch.randn(2, 160000, generator=torch.Generator().manual_seed(6))
    wav = (0.1 * wav).to(device)
    launches = tf32x3.tf32x3_gemm.launches
    calls = tf32x3.tf32x3_gemm.torch_calls
    with torch.inference_mode():
        ours = encoder(wav)
    assert tf32x3.tf32x3_gemm.launches == launches + 55
    assert tf32x3.tf32x3_gemm.torch_calls == calls
    with torch.enable_grad():
        theirs = encoder(wav)
    assert tf32x3.tf32x3_gemm.torch_calls == calls + 55
    for i, (a, b) in enumerate(zip(ours, theirs)):
        b = b.detach()
        gap = ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()
        assert gap <= 1e-4, f"state {i}: {gap:.3e}"
