"""The port stands alone: it imports nothing of JAX or of the JAX package,
and it never drops to the CPU unasked."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import dcnet_tpu_torch
from dcnet_tpu_torch.config import DCNetConfig
from dcnet_tpu_torch.models.darknet import mini_backbone_defs
from dcnet_tpu_torch.models.dcnet import DCNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dcnet_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dcnet_tpu",
             "transformers", "grain")


def _port_modules():
    return ["dcnet_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([PKG], "dcnet_tpu_torch.")]


def _run(code, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_importing_the_port_loads_no_jax():
    mods = _port_modules() + ["chip_smoke", "kernel_timing"]
    assert {"dcnet_tpu_torch.cli.test", "dcnet_tpu_torch.data.vid",
            "dcnet_tpu_torch.eval.ref_cache", "dcnet_tpu_torch.ops.quant",
            "dcnet_tpu_torch.kernels.conv_s8", "dcnet_tpu_torch.cli.train",
            "dcnet_tpu_torch.models.bert", "dcnet_tpu_torch.data.bert_tokenize",
            "dcnet_tpu_torch.data.grain_pipeline", "dcnet_tpu_torch.losses_extra",
            "dcnet_tpu_torch.train.checkpoint", "dcnet_tpu_torch.dryrun",
            "dcnet_tpu_torch.parallel.mesh", "dcnet_tpu_torch.native",
            "dcnet_tpu_torch.utils.profiling", "dcnet_tpu_torch.ops.yolo_detect"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_importing_the_cli_data_and_eval_modules_loads_no_cv2():
    """cv2 is imported only where a frame is decoded or drawn (the host
    loader and the profiling module import none either)."""
    mods = [m for m in _port_modules()
            if m.split(".")[1:2] in (["cli"], ["data"], ["eval"], ["native"], ["utils"])]
    assert "dcnet_tpu_torch.native" in mods and "dcnet_tpu_torch.utils.profiling" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('cv2', 'jax', 'dcnet_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("cli", ["test", "eval_single", "post_process", "train"])
def test_cli_main_raises_without_cuda(cli, tmp_path, monkeypatch):
    """Without DCNET_PLATFORM=cpu a CLI runs on the card, and raises where
    there is none."""
    import importlib
    main = importlib.import_module(f"dcnet_tpu_torch.cli.{cli}").main
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("DCNET_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "--lstm", "--mini", "--size", "64"])
    assert os.listdir(tmp_path) == []  # no logs, no data written


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+"
        r"(?:jax|jaxlib|flax|optax|orbax|dcnet_tpu|transformers|grain)(?:[.\s]|$)",
        re.M)
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "kernel_timing.py")]
    for root, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not source
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            hits = pattern.findall(f.read())
        assert not hits, f"{path} imports {hits}"


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dcnet_tpu_torch.default_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        DCNet(DCNetConfig(image_size=64, corpus_size=10),
              backbone_defs=mini_backbone_defs())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run("import runpy, sys; sys.argv = ['chip_smoke.py']; "
               "runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
