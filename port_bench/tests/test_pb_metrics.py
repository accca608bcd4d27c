"""The metric arithmetic against hand counts."""


import pb_tiny
import pytest

from harness import manifest, readers, roofline, stats
from harness.run_state import Decode, Run
from harness.tracing import Traced

MODEL = pb_tiny.tiny_config()["model"]


def test_union_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.merged(iv) == [(0, 3), (5, 6), (10, 10)]


def _traced(busy_s, window_s, complete=True):
    return Traced(window_s, busy_s, {}, {}, {}, 0, complete, [], [])


def test_idle_share_is_one_minus_busy_over_window():
    run = Run("c", {"model": MODEL}, {}, 1, 1.0, True)
    run.traced = _traced(0.25, 1.0)
    assert readers.idle_share(run) == pytest.approx(0.75)
    run.traced = _traced(0.25, 1.0, complete=False)   # missed launches
    assert readers.idle_share(run) is None


def test_step_bound_hand_count():
    """B1 at 2 rows, slot 3, on the real widths: the weights once (bf16),
    the float32 biases and norms, each row's cross K/V and prefix, x in
    and out, the fresh K/V rows."""
    m = pb_tiny.tiny_config()["model"]
    m.update(d_model=256, nhead=8, dim_feedforward=512,
             num_decoder_layers=8, encoder="swin_t", img_h=96, img_w=320)
    L, D, F, Le, R, P = 8, 256, 512, 30, 2, 3
    weights = L * (D * 3 * D + 3 * D * D + 2 * D * F)
    cols = L * (3 * D + 3 * D + F + D)
    want_bytes = (weights * 2 + (cols + 6 * L * D) * 4
                  + 2 * L * R * Le * D * 2 + 2 * L * R * P * D * 2
                  + R * D * 2 + R * D * 4 + 2 * L * R * D * 2)
    want_flops = 2 * R * weights + 4 * L * R * D * (P + 1 + Le)
    assert roofline.step_bound(m, R, P) == (want_bytes, want_flops)
    nb, fl, n = roofline.decode_work(m, [(R, 4)])
    assert n == 4
    assert nb == sum(roofline.step_bound(m, R, p)[0] for p in range(4))
    assert roofline.bound_ms(3.35e9, 0.0) == pytest.approx(1.0)
    assert roofline.bound_ms(0.0, 989e9) == pytest.approx(1.0)


def test_swin_block_work_hand_count():
    m = pb_tiny.tiny_config()["model"]
    m["swin"].update(embed_dim=96, depths=[2, 2, 6, 2],
                     num_heads=[3, 6, 12, 24])
    c, h, w, hid, ws = 96, 24, 80, 384, 7
    real = h * w
    want_flops = (2 * real * c * 3 * c + 4 * real * 49 * c
                  + 2 * real * (c * c + 2 * c * hid))
    assert roofline.swin_block_work(m, 1, 0)[1] == want_flops
    nb, fl, n = roofline.encode_work(m, [64])
    assert n == 10                       # stages 1-3 of 2/2/6/2
    assert fl == sum(d * roofline.swin_block_work(m, 64, s)[1]
                     for s, d in enumerate((2, 2, 6)))


def test_decoder_flops_hand_count():
    m = dict(MODEL, d_model=4, nhead=1, dim_feedforward=8,
             num_decoder_layers=1, vocab_size=10, encoder="resnet18",
             img_w=64)
    # L_enc = 2; per position: qkv 2*4*12, out, cross q, cross out 3 x 2*16,
    # FFN 2 * 2*4*8, head 2*4*10; cross K/V once 2*2*4*8; attention
    # 4*4*(1+2+3) self over 3 tokens and 4*4*3*2 cross
    per = 96 + 96 + 128 + 80
    want = 2 * 2 * 4 * 8 + 3 * per + 4 * 4 * 6 + 4 * 4 * 3 * 2
    assert roofline.decoder_flops(m, 3) == want


def test_resnet_encoder_flops_hand_count():
    m = dict(MODEL, encoder="resnet18", img_h=64, img_w=64, d_model=4,
             resnet={"in_channels": 1, "stage_channels": [2, 4],
                     "stage_blocks": [1, 1]})
    # conv1 at 32x32 (1->2, 7x7); pool to 16x16; block 1: two 3x3 2->2;
    # block 2 at 8x8: 3x3 2->4, 3x3 4->4, 1x1 2->4; projection 2 x 4 x 4
    want = (2 * 32 * 32 * 49 * 2
            + 2 * (2 * 16 * 16 * 9 * 2 * 2)
            + 2 * 8 * 8 * 9 * 2 * 4 + 2 * 8 * 8 * 9 * 4 * 4
            + 2 * 8 * 8 * 2 * 4 + 2 * 2 * 4 * 4)
    assert roofline.encoder_flops(m) == want


def test_row_steps_wasted_and_batch_images():
    run = Run("c", {"model": MODEL}, {}, 1, 1.0, False)
    run.t0 = 0.0
    run.decodes = [Decode(64, 60, 50, 1500, end=0.5),
                   Decode(16, 10, 20, 200, end=0.9),
                   Decode(64, 64, 50, 3000, end=1.5)]   # after the window
    wasted = manifest.load_module("metrics", "row_steps_wasted.bulk")
    assert wasted.read(run) == pytest.approx(1 - 1700 / (64 * 50 + 16 * 20))
    batch = manifest.load_module("metrics", "batch_images.bulk")
    assert batch.read(run) == pytest.approx(35.0)


def test_roofline_reader_needs_the_counters_to_agree():
    m = pb_tiny.tiny_config()["model"]
    run = Run("c", {"model": m}, {}, 1, 1.0, True)
    run.decodes = [Decode(16, 10, 5, 30, traced=True)]
    name = "(anonymous namespace)::fused_step_cluster_kernel<bf16>"
    nb, fl, _ = roofline.decode_work(m, [(16, 5)])
    bound_s = roofline.bound_ms(nb, fl) * 1e-3
    run.traced = Traced(1.0, 0.5, {name: 4 * bound_s}, {name: 5},
                        {("fused_decoder_layers_step_v2", "launches"): 5},
                        5, True, [], [])
    reader = manifest.load_module("metrics", "fused_step_roofline.bulk")
    assert reader.read(run) == pytest.approx(25.0)
    run.traced.kernel_n[name] = 4        # the profiler missed one
    assert reader.read(run) is None
