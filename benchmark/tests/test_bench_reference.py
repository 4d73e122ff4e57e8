"""The reference against the port at tiny sizes on the CPU: each layer it
covers, the draws it works out again, and whole runs of both cells' drivers
coming out correct."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.reference import clip as ref_clip
from benchmark.reference import field as ref_field
from benchmark.reference import training as ref_training
from benchmark.reference.precision import REFERENCE, fp8_round
from benchmark.tests.tiny import TINY_CLIP, tiny_ctx

CPU = torch.device("cpu")
FIELD = dict(field_type="mlp", posenc_deg=10, mlp_width=256, mlp_depth=5, skip_layer=3,
             geo_feat_dim=15, color_width=64, n_color_layers=3, sh_degree=4,
             aabb_min=[0.05, -0.55, -0.15], aabb_max=[1.15, 1.55, 1.35])


def _port_field(w):
    from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField

    f = NGPField(NGPConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in FIELD.items()}), device="cpu")
    f.load_state_dict(w)
    return f


def test_field_against_the_port():
    from dream2real_tpu_torch.nerf.model import field_fn

    g = torch.Generator().manual_seed(0)
    w = scene.field_weights(torch, g, FIELD, CPU)
    pos = torch.rand(512, 3, generator=g) * 1.2 + torch.tensor([0.0, -0.6, -0.2])
    d = torch.nn.functional.normalize(torch.randn(512, 3, generator=g), dim=-1)
    sig_p, rgb_p = field_fn(_port_field(w), pos, d)
    sig_r, rgb_r = ref_field.Field(w, FIELD, REFERENCE)(pos, d)
    # The port rounds activations to bf16 between layers: a few bf16 steps
    # through five layers.
    assert torch.allclose(torch.log(sig_p + 1e-6), torch.log(sig_r + 1e-6), atol=0.1)
    assert (rgb_p - rgb_r).abs().max() < 0.02


def test_march_against_the_ports_plain_k1():
    from dream2real_tpu_torch.nerf import march_kernel as mk
    from dream2real_tpu_torch.nerf.render import RenderSettings

    g = torch.Generator().manual_seed(1)
    w = scene.field_weights(torch, g, FIELD, CPU)
    box = ((0.39, -0.15, -0.03), (0.53, -0.01, 0.13))
    o = torch.tensor([[0.5, 0.4, 0.4]]).expand(1, 3)
    d = torch.randn(1, 300, 3, generator=g) * 0.15 + torch.tensor([0.0, -1.0, -0.8])
    d = d / d[..., 2:].abs()
    st = RenderSettings(n_coarse=20, n_fine=0, near=0.1, far=4.0)
    out = mk.march_rays_fused(mk.pack_params(_port_field(w)), o, d, box, st)
    r, a, z, needed, live = ref_field.march_box(
        ref_field.Field(w, FIELD, REFERENCE), o.expand(300, 3), d[0], box,
        {"n_coarse": 20, "near": 0.1, "far": 4.0, "min_transmittance": 1e-4}, count=True)
    assert live > 50 and needed > live
    assert (out["alpha"][0] - a).abs().max() < 0.03
    assert (out["rgb"][0] - r).abs().max() < 0.03


def test_towers_against_the_port():
    from dream2real_tpu_torch.clip.model import CLIPConfig, CLIPModel, encode_image, encode_text

    c = dict(CLIPConfig()._asdict(), **TINY_CLIP)
    g = torch.Generator().manual_seed(2)
    w = scene.clip_weights(torch, g, c, CPU)
    model = CLIPModel(CLIPConfig(**c), device="cpu")
    model.load_state_dict(w)
    px = torch.randn(3, 56, 56, 3, generator=g)
    ids = torch.as_tensor(scene.hash_tokenize(["a red box", "the green box on top"]))
    for port, ref in ((encode_image(model, px), ref_clip.encode_image(w, c, px, REFERENCE)),
                      (encode_text(model, ids), ref_clip.encode_text(w, c, ids, REFERENCE))):
        cos = torch.nn.functional.cosine_similarity(port, ref, dim=-1)
        assert cos.min() > 0.999, cos


def test_hash_tokenizer_is_the_ports():
    from dream2real_tpu_torch.clip.tokenizer import hash_tokenize

    caps = ["a red box on top of the green box", "a red box and a green box"]
    assert np.array_equal(scene.hash_tokenize(caps), hash_tokenize(caps))


def test_tabletop_is_the_ports_synthetic_scene():
    from dream2real_tpu_torch.data import synth

    K = scene.intrinsics({"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 20.0}, 1.0)
    T = scene.orbit(3, 0.55, 0.45)
    rgb, depth, inst = scene.render_tabletop(torch, T, K, 40, 64, CPU)
    for v in range(3):
        r, dd, ii = synth.render_scene(synth.default_scene(), T[v].astype(np.float64), K, 40, 64)
        assert np.array_equal(inst[v].numpy(), ii)
        assert np.abs(depth[v].numpy() - dd).max() < 1e-5
        assert np.abs(rgb[v].numpy().astype(int) - r).max() <= 1


def test_pose_grid_is_the_ports():
    from dream2real_tpu_torch.sampling import sample_poses_grid

    b = [[-0.2, 0.2], [-0.2, 0.2], [0.0, 0.12], [0, 0], [0, 0], [0, 0]]
    ours = scene.pose_grid([5, 4, 3, 1, 1, 1], b)
    port = sample_poses_grid(scene.CENTRE, [5, 4, 3, 1, 1, 1], scene_type=3, bounds_override=b)
    assert np.array_equal(ours.reshape(-1, 16), port)


def test_training_draws_are_the_programs():
    """The reference's initial field is the program's bit for bit: the same
    draws from the same seed."""
    from dream2real_tpu_torch.nerf.model import NGPConfig
    from dream2real_tpu_torch.nerf.trainer import TrainConfig, init_train_state

    ngp = NGPConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in FIELD.items()})
    state = init_train_state(ngp, TrainConfig(seed=2**31 + 11), n_images=2, device="cpu")
    ref = ref_training.init_weights(torch.Generator().manual_seed(2**31 + 11), FIELD, CPU)
    for k, p in state["field"].named_parameters():
        assert torch.equal(p.detach(), ref[k]), k


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.linspace(-3.0, 3.0, 1001)
    err = (fp8_round(x) - x).abs() / x.abs().clamp(min=1e-3)
    assert err.max() <= 2.0 ** -4 + 1e-6 and err.max() > 2.0 ** -8


@pytest.mark.parametrize("cell", ["clip-vitl14-336.shopping_grid", "field-mlp256.fg_task"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_whole_tiny_run_is_correct(cell, trace):
    from benchmark import harness

    ctx = tiny_ctx(cell, seed=2**31 + 3, trace=trace)
    out = harness.load_driver(ctx.cell.traffic).run(ctx)
    assert out.correct, out.compared
    assert out.attempted > 0 and out.failed == 0
    assert all(math.isfinite(v) for v, _ in out.compared.values())
    line = harness.result_line(out, ctx.cell, trace, {"platform": "cpu"})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in ctx.cell.end_to_end}
