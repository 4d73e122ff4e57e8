"""The port stands alone: no file of dream2real_tpu_torch/ nor chip_smoke.py
imports jax or anything of the JAX package, and importing every module of
the port leaves jax unimported."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "dream2real_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "dream2real_tpu")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        "before = 'jax' in sys.modules\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "assert before or 'jax' not in sys.modules, 'the port imported jax'\n"
        "assert not any(m == 'dream2real_tpu' or m.startswith('dream2real_tpu.')\n"
        "               for m in sys.modules), 'the port imported the JAX package'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_a_silent_cpu_fallback():
    """Without a GPU, an entry point not given device="cpu" raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    from dream2real_tpu_torch.clip.model import CLIPConfig, CLIPModel
    from dream2real_tpu_torch.nerf.model import NGPConfig, NGPField
    from dream2real_tpu_torch.nerf.render import RenderSettings
    from dream2real_tpu_torch.ops.cameras import pixel_dirs
    from dream2real_tpu_torch.parallel.imagine import make_imagine_and_score

    K = [[10.0, 0, 4], [0, 10.0, 4], [0, 0, 1]]
    tiny = CLIPConfig(image_size=8, patch_size=4, vision_width=8, vision_layers=1,
                      vision_heads=1, text_width=8, text_layers=1, text_heads=1,
                      projection_dim=4, vocab_size=16, context_length=4)
    calls = [
        lambda: pixel_dirs(8, 8, K),
        lambda: NGPField(NGPConfig()),
        lambda: CLIPModel(tiny),
        lambda: make_imagine_and_score(NGPConfig(), tiny, RenderSettings(),
                                       pixel_dirs(8, 8, K, device="cpu"), 1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert NGPField(NGPConfig(), device="cpu").trunk_w0.device.type == "cpu"
