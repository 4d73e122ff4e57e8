"""The yardstick's counts: the published towers' multiply-adds, the tower's
GEMMs as the port runs them, and the kernels' packed weights as the port
lays them out."""

from __future__ import annotations

import pytest

from benchmark import roofline


def test_vit_l14_336_is_190_9_g_multiply_adds():
    macs = roofline.vit_macs()
    assert abs(macs - 190.9e9) / 190.9e9 < 0.005
    # Its parts as published: the patch embedding 0.35 G, a block's dense
    # layers 577 x 12.58 M, its attention products 0.68 G.
    assert abs(576 * 14 * 14 * 3 * 1024 - 0.35e9) / 0.35e9 < 0.02
    assert abs(12 * 1024 * 1024 - 12.58e6) / 12.58e6 < 0.001
    assert abs(2 * 577 * 577 * 1024 - 0.68e9) / 0.68e9 < 0.005


def test_tower_gemms_of_a_clip_group():
    gemms = roofline.tower_gemms(32)
    assert len(gemms) == 96  # four a block, 24 blocks
    M = 32 * 577
    assert gemms[0] == ("qkv", M, 1024, 3072, False)
    assert gemms[2] == ("fc1", M, 1024, 4096, False)
    assert gemms[-1] == ("fc2", 32, 4096, 1024, True)  # the last block: class token only
    flops, nbytes = roofline.gemm_flops_bytes(M, 1024, 4096, False)
    assert flops == 2.0 * M * 1024 * 4096
    assert nbytes == M * 1024 * 2 + 1024 * 4096 * 2 + 4096 * 4 + M * 4096 * 2
    # Every full-size GEMM of the tower is bound by its operations.
    for _, m, k, n, r in gemms[:4]:
        assert roofline.bound_ms(*roofline.gemm_flops_bytes(m, k, n, r))[1] == "operations"


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert roofline.bound_ms(989e12, 0.0) == (1000.0, "operations")
    assert roofline.bound_ms(0.0, 3.35e12) == (1000.0, "bytes")


def test_packed_weights_match_the_ports_layouts():
    from dream2real_tpu_torch.nerf import march_kernel as mk
    from dream2real_tpu_torch.nerf import train_kernel as tk

    assert roofline.K1_W == mk.N_W and roofline.K1_B == mk.N_B
    assert roofline.TRAIN_W == tk.N_W and roofline.TRAIN_B == tk.N_B
    assert roofline.TRAIN_G == tk.N_G


def test_field_macs_are_the_flagship_fields():
    from dream2real_tpu_torch.nerf.model import NGPConfig, layer_dims

    dims = layer_dims(NGPConfig())
    trunk = sum(dims[f"trunk_w{i}"][0] * dims[f"trunk_w{i}"][1] for i in range(5))
    colour = sum(dims[f"color_w{i}"][0] * dims[f"color_w{i}"][1] for i in range(3))
    assert roofline.TRUNK_MACS == trunk and roofline.COLOUR_MACS == colour


@pytest.mark.parametrize("rays,samples", [(4096, 64), (8192, 64)])
def test_training_counts(rays, samples):
    f = roofline.train_step_flops(rays, 32, samples, 8)
    fwd = 2.0 * roofline.FIELD_MACS * rays * samples
    # 3 x the forward, the sampler about half a forward, the carving 3/8 of one
    assert 3.8 * fwd < f < 3.9 * fwd
    assert roofline.k7_flops(rays, samples) == 2.0 * roofline.BWD_MACS * rays * samples
