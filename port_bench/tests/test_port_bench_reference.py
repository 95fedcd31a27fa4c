"""The plain reference agrees with the port's plain CPU path at a tiny
configuration (float32 on both sides, the same seeded weights), and the
benchmark's PNG decoder reads every filter type."""

import struct
import zlib

import numpy as np
import pytest
import torch

from port_bench import pngdec, reference, system, weights
from port_bench.tests import tiny


@pytest.mark.parametrize("name", ["sd15-lcm-512", "sdxl-lcm-1024"])
def test_reference_agrees_with_the_ports_plain_path(name):
    system.import_program()
    config = tiny.config(name)
    words, voc, merges = system.run_vocabulary(11)
    states = weights.state_dicts(config, 11, "cpu", torch.float32)
    pipe = system.pipeline.LCMPipeline(system.make_bundle(config, states, voc, merges),
                                       dtype=torch.float32, device="cpu")
    ref = reference.Pipeline(config, states, voc)
    for prompt, seed, (h, w) in ((" ".join(words[:7]), 2**31 - 5, (32, 48)),
                                 (" ".join(words[100:103]), 12, (48, 32))):
        got = pipe.generate(prompt, height=h, width=w, num_inference_steps=4, seed=seed).images[0]
        want = ref(prompt, seed, h, w, 4)
        assert got.shape == want.shape == (h, w, 3)
        # the same arithmetic in another order: at most one level on a rounding edge
        d = np.abs(got.astype(int) - want.astype(int))
        assert d.max() <= 1 and d.mean() < 0.01
        assert 10 < want.std() and (want == 0).mean() + (want == 255).mean() < 0.05


@pytest.mark.parametrize("workload", ["sd15-512-serial", "sdxl-1024-serial", "sd15-512-burst8"])
def test_the_control_is_not_correct(workload):
    """The float8 control, held to each cell's limits at a tiny size, fails
    them (on the card at the cells' size: test_port_bench_card.py)."""
    from port_bench import checks, control

    name = "sdxl-lcm-1024" if workload.startswith("sdxl") else "sd15-lcm-512"
    got = control.readings(tiny.config(name), tiny.mix("poisson-sd15-512"), 5, 10.0, "cpu")
    assert not checks.passed(checks.verdict(got, checks.limits(workload))), got


def _png(img: np.ndarray, filt: int) -> bytes:
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = []
    prior = np.zeros(w * c, np.int32)
    for y in range(h):
        line = rows[y]
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prior[:-c]])
        if filt == 0:
            pred = np.zeros_like(line)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([filt]) + ((line - pred) % 256).astype(np.uint8).tobytes())
        prior = line

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[c], 0, 0, 0)
    return (pngdec.SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder(filt, channels):
    img = np.random.default_rng(filt).integers(0, 256, (9, 13, channels), dtype=np.uint8)
    np.testing.assert_array_equal(pngdec.decode(_png(img, filt)).reshape(img.shape), img)


def test_png_decoder_reads_the_ports_encoder_and_checks_crcs():
    from dreamlab_tpu_torch.utils.png import encode_png

    img = np.random.default_rng(0).integers(0, 256, (17, 11, 3), dtype=np.uint8)
    data = encode_png(img, {"parameters": "x"})
    np.testing.assert_array_equal(pngdec.decode(data), img)
    bad = bytearray(data)
    bad[-20] ^= 1
    with pytest.raises(ValueError):
        pngdec.decode(bytes(bad))
