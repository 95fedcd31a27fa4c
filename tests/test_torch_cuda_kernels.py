"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc (they build the kernels from
``dreamlab_tpu_torch/csrc``) and skip elsewhere. They import no JAX, so on a
machine without it run them as

    python -m pytest --noconftest -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerances: in fp32 (TF32 off) the kernels differ from the plain versions only
in summation order, so 1e-4 (attention) and 1e-5 (GroupNorm); in bf16 the
kernel is compared with the plain version computed in fp32 on the same bf16
inputs, so the bound is the output's bf16 rounding: 2e-2.
"""

import numpy as np
import pytest
import torch

from dreamlab_tpu_torch.ops import _build
from dreamlab_tpu_torch.ops import flash_attention as fa
from dreamlab_tpu_torch.ops import flash_group as fg
from dreamlab_tpu_torch.ops import groupnorm as gn
from dreamlab_tpu_torch.scripts import ab_attention_layout as layout

pytestmark = pytest.mark.requires_cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def test_build_reports_registers(cuda):
    log = _build.build_log()
    print(log)
    assert "flash_fwd_kernel" in log and "gn_apply_kernel" in log
    assert "flash_group_kernel" in log


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,m,h,d", [
    (1, 256, 256, 8, 40),
    (1, 256, 77, 8, 40),     # masked key edge, cross-attention length
    (1, 256, 1000, 8, 80),   # masked edge across several key tiles
    (2, 200, 300, 2, 64),    # ragged query edge
    (1, 128, 128, 2, 128),   # widest head dim
    (1, 1024, 1024, 8, 80),  # UNet level 2
])
def test_flash_matches_plain(cuda, dtype, b, n, m, h, d):
    q = _randn((b, n, h, d), dtype, cuda, 0)
    k = _randn((b, m, h, d), dtype, cuda, 1)
    v = _randn((b, m, h, d), dtype, cuda, 2)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    err = (got.float() - want).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("block_q,block_k", [(64, 16), (64, 32), (64, 64), (128, 16),
                                             (128, 64)])
@pytest.mark.parametrize("d", [16, 40])
def test_flash_tile_sweep_matches_plain(cuda, block_q, block_k, d):
    b, n, m, h = 1, 300, 77, 2  # ragged query and key edges
    q, k, v = (_randn(s, torch.bfloat16, cuda, i) for i, s in enumerate(
        [(b, n, h, d), (b, m, h, d), (b, m, h, d)]))
    got = fa.flash_attention(q, k, v, block_q=block_q, block_k=block_k)
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]


def test_flash_tile_sweep_is_bf16_at_narrow_heads_only(cuda):
    q = torch.zeros((1, 128, 2, 40), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, block_q=64)
    q = torch.zeros((1, 128, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q, block_k=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,n,m,h,d,pack", [
    (1, 256, 256, 6, 40, 3),
    (2, 200, 77, 6, 40, 3),    # ragged query edge, masked keys
    (1, 256, 1000, 4, 64, 2),  # masked edge across several key tiles
    (1, 256, 300, 8, 40, 2),
    (2, 130, 50, 6, 16, 3),
    (1, 128, 33, 2, 16, 2),
    (1, 128, 100, 4, 24, 2),   # zero-padded in registers to 40
])
def test_flash_group_matches_plain(cuda, dtype, b, n, m, h, d, pack):
    q = _randn((b, n, h, d), dtype, cuda, 0)
    k = _randn((b, m, h, d), dtype, cuda, 1)
    v = _randn((b, m, h, d), dtype, cuda, 2)
    before = fg.LAUNCHES
    got = fg.flash_group(q, k, v, pack=pack)
    torch.cuda.synchronize()
    assert fg.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
    err = (got.float() - want).abs().max().item()
    assert err <= TOL[dtype], err


def test_flash_group_reads_token_strided_views(cuda):
    """q/k/v as views into one packed projection output: the group's lanes
    stay contiguous, only the token stride grows."""
    b, n, h, d = 2, 256, 6, 40
    qkv = _randn((b, n, 3, h * d), torch.bfloat16, cuda, 3)
    q, k, v = (qkv[:, :, i].reshape(b, n, h, d) for i in range(3))
    got = fg.flash_group(q, k, v, pack=3)
    want = fg.flash_group_plain(q.float(), k.float(), v.float(), d ** -0.5)
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    with pytest.raises(ValueError):  # heads not lane-adjacent
        fg.flash_group(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, pack=3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("lane", [40, 128])
def test_kernel_call_matches_plain(cuda, dtype, lane):
    x = [_randn((2, 300, 4, 40), dtype, cuda, i) for i in range(3)]
    q, k, v = (layout.fold(t, lane) for t in x)
    before = layout.LAUNCHES
    got = layout.kernel_call(q, k, v, lane, scale=40 ** -0.5)
    torch.cuda.synchronize()
    assert layout.LAUNCHES == before + 1
    want = fa.attention_plain(*(t.float().unsqueeze(2) for t in (q, k, v)),
                              40 ** -0.5).squeeze(2)
    assert (got.float() - want).abs().max().item() <= TOL[dtype]
    assert not got[:, :, 40:].any()


def test_flash_reads_strided_views(cuda):
    """q/k/v as views into one packed projection output: no copies needed."""
    b, n, h, d = 2, 256, 4, 40
    qkv = _randn((b, n, 3, h * d), torch.bfloat16, cuda, 3)
    q, k, v = (qkv[:, :, i].reshape(b, n, h, d) for i in range(3))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v)
    want = fa.attention_plain(q.float(), k.float(), v.float(), d ** -0.5)
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]


def test_flash_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 128, 2, 160), device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 40), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,groups", [
    ((1, 64, 64, 320), 32),
    ((1, 16, 16, 2560), 32),
    ((2, 5, 7, 64), 8),        # rows not a multiple of the tile
    ((1, 512, 512, 128), 32),  # VAE's last level
])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "nosilu"])
def test_group_norm_matches_plain(cuda, dtype, shape, groups, silu):
    c = shape[-1]
    x = _randn(shape, dtype, cuda, 4)
    rs = np.random.RandomState(5)
    scale = torch.from_numpy(1 + 0.1 * rs.randn(c).astype(np.float32)).to(cuda, dtype)
    bias = torch.from_numpy(0.1 * rs.randn(c).astype(np.float32)).to(cuda, dtype)
    s0, a0 = gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES
    got = gn.fused_group_norm_silu(x, scale, bias, groups=groups, silu=silu)
    torch.cuda.synchronize()
    assert (gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES) == (s0 + 1, a0 + 1)
    want = gn.group_norm_plain(x.float(), scale.float(), bias.float(),
                               groups=groups, silu=silu)
    err = (got.float() - want).abs().max().item()
    assert err <= GN_TOL[dtype], err


def test_group_norm_coeffs_match_plain(cuda):
    x = _randn((2, 32, 32, 640), torch.float32, cuda, 6) + 3.0
    scale = torch.ones(640, device=cuda)
    bias = torch.zeros(640, device=cuda)
    a, b = gn.group_norm_coeffs(x, scale, bias, groups=32)
    a0, b0 = gn.group_norm_coeffs_plain(x, scale, bias, groups=32)
    assert (a - a0).abs().max().item() <= 1e-5
    assert (b - b0).abs().max().item() <= 1e-5
