"""The benchmark's operation counts match FlopCounterMode over the plain
reference, and its kernel census matches the calls the port makes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops, reference, system, weights
from port_bench.tests import tiny

CONFIGS = ["sd15-lcm-512", "sdxl-lcm-1024"]


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_match_the_flop_counter_over_the_reference(name):
    config = tiny.config(name)
    words, voc, _ = system.run_vocabulary(3)
    ref = reference.Pipeline(config, weights.state_dicts(config, 3, "cpu", torch.float32), voc)
    with FlopCounterMode(display=False) as counter:
        ref(" ".join(words[:5]), 77, 64, 96, 2)
    assert counter.get_total_flops() == flops.image_work(config, 64, 96, 2).flops


@pytest.mark.parametrize("name", CONFIGS)
def test_full_size_counts(name):
    """The published widths: an image's FLOPs and the kernels' census."""
    import json

    config = json.loads((tiny.HERE / "configs" / f"{name}.json").read_text())
    size = 512 if name.startswith("sd15") else 1024
    work = flops.image_work(config, size, size, 4)
    unet = work.parts["unet"] / 4
    if name.startswith("sd15"):
        assert abs(unet - 0.803e12) < 0.001e12 and abs(work.parts["vae"] - 2.51e12) < 0.01e12
        assert flops.census(config, size, size, 4) == (40, 209)
    else:
        assert abs(unet - 6.76e12) < 0.01e12
        assert flops.census(config, size, size, 4) == (280, 169)


@pytest.mark.parametrize("name", CONFIGS)
def test_census_matches_the_ports_calls(name):
    """The GroupNorm+SiLU calls and the self-attention calls K1's route takes
    (at least 256 tokens, d <= 128: in the UNet, and at toy widths in the
    VAE's mid block too) that the port's plain path makes."""
    from dreamlab_tpu_torch.models import layers, unet, vae
    from dreamlab_tpu_torch.ops import attention

    system.import_program()
    config = tiny.config(name)
    words, voc, merges = system.run_vocabulary(3)
    bundle = system.make_bundle(config, weights.state_dicts(config, 3, "cpu", torch.float32),
                                voc, merges)
    pipe = system.pipeline.LCMPipeline(bundle, dtype=torch.float32, device="cpu")
    seen = {"gn": 0, "flash": 0}
    gn, dpa = layers.fused_group_norm_silu, attention.dot_product_attention

    def count_gn(*a, **k):
        seen["gn"] += 1
        return gn(*a, **k)

    def count_attention(q, k, v, **kw):
        n, m, d = q.shape[1], k.shape[1], q.shape[3]
        seen["flash"] += int(n >= 256 and m >= 256 and d <= 128)
        return dpa(q, k, v, **kw)

    layers.fused_group_norm_silu = count_gn
    unet.dot_product_attention = vae.dot_product_attention = count_attention
    try:
        pipe.generate(" ".join(words[:4]), height=128, width=128, num_inference_steps=2, seed=1)
    finally:
        layers.fused_group_norm_silu = gn
        unet.dot_product_attention = vae.dot_product_attention = dpa
    assert (seen["flash"], seen["gn"]) == flops.census(config, 128, 128, 2)
    assert seen["flash"] > 0


def test_bounds():
    a = flops.Attention(4096, 4096, 8, 40, True)
    assert a.on_flash and not flops.Attention(4096, 77, 8, 40, False).on_flash
    ops_s = 4 * 4096 * 4096 * 8 * 40 / flops.PEAK_BF16_FLOPS
    assert a.bound_s() == pytest.approx(ops_s) and a.bound_s(8) == pytest.approx(8 * ops_s)
    g = flops.GroupNormSilu(64 * 64 * 320, 320)
    assert g.bound_s() == pytest.approx((4 * 64 * 64 * 320 + 4 * 320) / flops.HBM_BYTES_PER_S)
