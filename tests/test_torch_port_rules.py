"""Rules of the PyTorch port: it stands apart from the JAX package, and
its entry points run on CUDA unless the CPU is asked for -- they never
carry on on the CPU by themselves."""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from idc_models_tpu_torch import cli, resolve_device
from idc_models_tpu_torch.data import idc as tidc
from idc_models_tpu_torch.models import small_cnn as tsmall
from idc_models_tpu_torch.secure import fedavg as tsecure
from idc_models_tpu_torch.train import losses as tlosses
from idc_models_tpu_torch.ops import build
from idc_models_tpu_torch.ops import fused_conv as tfc
from idc_models_tpu_torch.ops import secure_masking_kernel as tsmk
from idc_models_tpu_torch.train import loop as tloop

REPO = Path(__file__).resolve().parent.parent
# every module of the port (collectives.py, mesh.py, data/sequences.py
# and serve/ among them), the card's smoke script, and the rank processes
# of the multi-rank ring and distribution tests, which must start
# without JAX
PORT_FILES = sorted((REPO / "idc_models_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "_torch_ring_worker.py",
    REPO / "tests" / "_torch_dist_worker.py"]


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "optax", "idc_models_tpu"), (
            f"{path.relative_to(REPO)} imports {mod}")


def test_every_cuda_source_names_the_tpu_kernel_it_replaces():
    for cu in (REPO / "idc_models_tpu_torch").rglob("*.cu"):
        head = cu.read_text()[:2000]
        assert "Replaces the TPU kernel idc_models_tpu/" in head, cu
        assert "Bound on an H100" in head, cu


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_defaults_to_cuda_and_refuses_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda_unless_given_cpu(no_cuda):
    imgs = np.zeros((8, 8, 8, 3), np.float32)
    ds = tidc.ArrayDataset(imgs, np.zeros(8, np.int32))
    cfg = tloop.TwoPhaseConfig(epochs=0, fine_tune_epochs=0, batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.two_phase_fit("mobilenet_v2", 1, ds, ds, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["mobile", "--synthetic-examples", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["mobile", "--device", "cuda"])
    # the same call with the CPU asked for runs
    tloop.two_phase_fit("mobilenet_v2", 1, ds, ds, cfg, device="cpu")

    # the secure-aggregation entry points, likewise
    model = tsmall.small_cnn(10, 3, 1)
    bce = tlosses.binary_cross_entropy
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsecure.make_secure_fedavg_round(model, 1e-3, bce, percent=0.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["secure-fed", "--synthetic-examples", "40"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsecure.PaillierClient(model, 1e-3, bce, imgs, ds.labels, 0, 0.5,
                               None, None)
    tsecure.make_secure_fedavg_round(model, 1e-3, bce, percent=0.5,
                                     device="cpu")


def test_population_entry_points_raise_without_cuda_unless_given_cpu(
        no_cuda):
    from idc_models_tpu_torch.federated import (
        ClientPopulation, CohortSampler, make_async_round,
        make_population_round,
    )

    pop = ClientPopulation(16, examples_per_client=4)
    sampler = CohortSampler(pop, 4)
    model = tsmall.small_cnn(10, 3, 1)
    bce = tlosses.binary_cross_entropy
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_population_round(model, 1e-3, bce, pop, sampler, wave_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_async_round(model, 1e-3, bce, pop, sampler, buffer_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fed", "--population", "16", "--cohort", "4"])
    make_population_round(model, 1e-3, bce, pop, sampler, wave_size=2,
                          device="cpu")
    make_async_round(model, 1e-3, bce, pop, sampler, buffer_size=2,
                     device="cpu")


def test_kernel_path_refuses_to_build_or_launch_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tfc.KERNEL.lib()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        build.build_all([tfc.KERNEL])
    x = torch.zeros(1, 4, 4, 2)
    w = torch.zeros(3, 3, 1, 2)
    one = torch.ones(2)
    # a CPU tensor never reaches the kernel; a kernel launch refuses it
    with pytest.raises(ValueError, match="CUDA device"):
        tfc._launch(x, w, one, one, (1, 1), True)
    before = tfc.KERNEL.launches
    tfc.fused_depthwise_affine(x, w, one, one)
    assert tfc.KERNEL.launches == before

    # the secure masking kernel, likewise
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tsmk.KERNEL.lib()
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        build.build_all([tfc.KERNEL, tsmk.KERNEL])
    seeds, signs = tsmk.pair_seeds_and_signs(1, 0, 3)
    with pytest.raises(ValueError, match="CUDA device"):
        tsmk._launch(torch.zeros(5), seeds, signs, 20, 64.0)
    before = tsmk.KERNEL.launches
    tsmk.fused_masked_quantize(torch.zeros(5), seeds, signs, scale_bits=20,
                               clip_abs=64.0)
    assert tsmk.KERNEL.launches == before


def test_kernel_build_names_sm90a_and_a_source_hash():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    lib = tfc.KERNEL.library_path()
    assert lib.parent == build.BUILD_DIR and lib.name.startswith(
        "libfused_depthwise-")
    assert tsmk.KERNEL.library_path().name.startswith("libsecure_masking-")
    assert "idc_models_tpu_torch/_build/" in (
        REPO / ".gitignore").read_text().splitlines()


def test_native_loader_builds_from_the_ports_own_source():
    """The PNG loader's C++ source is the port's own file, and the
    binding compiles it into the port's build directory -- never the
    JAX package's source or binary."""
    from idc_models_tpu_torch.data import native

    port = REPO / "idc_models_tpu_torch"
    jax_native = REPO / "idc_models_tpu" / "data" / "native"
    assert native._SRC == port / "data" / "native" / "loader.cpp"
    assert native._SRC.is_file()
    assert native._SO.parent == build.BUILD_DIR
    for path in (native._SRC, native._SO):
        assert port in path.parents and jax_native not in path.parents
    assert "idc_models_tpu/data/native" not in (
        port / "data" / "native" / "__init__.py").read_text().replace(
        "``idc_models_tpu/data/native/__init__.py``", "")
