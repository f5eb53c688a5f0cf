"""obmd_tpu_torch's import and device rules: it imports with JAX blocked,
no file of it (its Python, CUDA and C++ sources, nor chip_smoke.py,
lj_state_point.py, the benches, profile_torch.py or the C client's
tests/torch_capi_support.py, which chip_smoke.py loads) names JAX or the
JAX package, and on a machine without a GPU the default device raises instead
of running on the CPU."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "obmd_tpu_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        yield ".".join(rel.parts).removesuffix(".__init__")


def test_imports_with_jax_blocked():
    mods = list(_modules())
    for m in ("obmd_tpu_torch.forces.pair_kernel",
              "obmd_tpu_torch.forces.bonded", "obmd_tpu_torch.io.lammps_data",
              "obmd_tpu_torch.forces.gathered",
              "obmd_tpu_torch.parallel.comm",
              "obmd_tpu_torch.parallel.atom_decomp",
              "obmd_tpu_torch.parallel.slab_decomp",
              "obmd_tpu_torch.parallel.ranks",
              "obmd_tpu_torch.parallel.dryrun"):
        assert m in mods
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['obmd_tpu'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_no_file_names_jax():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) \
        + sorted(PKG.rglob("*.cpp")) \
        + [ROOT / name for name in ("chip_smoke.py", "lj_state_point.py",
                                    "bench_torch.py", "bench_lj_torch.py",
                                    "bench_chain_torch.py",
                                    "profile_torch.py",
                                    "tests/torch_capi_support.py")]
    pat = re.compile(r"\bjax\b|obmd_tpu\.|import obmd_tpu\b")
    for p in files:
        for i, line in enumerate(p.read_text().splitlines(), 1):
            assert not pat.search(line), f"{p.relative_to(ROOT)}:{i}: {line}"


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from obmd_tpu_torch import convert, scenes
    from obmd_tpu_torch.state import init_state, resolve_device
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.obmd_dpd_scene(scale=0.25)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.lj_melt_scene(nx=2)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.obmd_lj_scene(nx=4, ny=4)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.chain_scene(nx=5)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.obmd_ljrf_scene(nx=4, ny=4)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.ljrf_bulk_scene(nx=2)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.dpd_tstat_scene(box_l=5.0)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.near_box_scene()
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.dpd_film_scene(y_open=True)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.star_melt_scene(n_stars=8)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.golden_scene("improper_golden")
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.obmd_dpdext_scene(scale=0.25)
    with pytest.raises(RuntimeError, match="cuda"):
        scenes.dpdext_golden_scene()
    cfg = scenes.obmd_dpd_config(scale=0.25)
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(cfg, [[1.0, 1.0, 1.0]])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.from_arrays({})
    assert resolve_device("cpu").type == "cpu"
