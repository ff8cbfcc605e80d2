"""Package rules of the port (tgb_tgn_dgl_tpu_torch): it imports neither
JAX nor the JAX package, builds nothing at import, compiles only its own
sources (csrc/) into its own _build/, and its CUDA sources export the
entry points their wrappers call."""
import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "tgb_tgn_dgl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "tgb_tgn_dgl_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "ab_attention_cuda.py",
                                         ROOT / "sweep_attention_bwd.py",
                                         ROOT / "trajectory_sensitivity.py",
                                         ROOT / "sharded_multi_gpu.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_cuda_source_exports_every_wrapped_entry_point():
    from tgb_tgn_dgl_tpu_torch.ops import attention
    src = (PKG / "csrc" / "attention.cu").read_text()
    exported = set(re.findall(r"^int (\w+)\(", src, flags=re.M))
    assert exported == set(attention.KERNELS) == set(attention._ARGTYPES)
    for name in attention.KERNELS:
        n_ptr = src.split(f"int {name}(")[1].split(")")[0].count("void*")
        assert n_ptr == sum(t is attention._P
                            for t in attention._ARGTYPES[name]), name


def test_gather_source_exports_its_entry_points():
    """csrc/gather.cu exports the kernel ops/gather.py launches, with as
    many pointers as its argtypes, and the workspace layout it reads."""
    from tgb_tgn_dgl_tpu_torch.ops import gather
    src = (PKG / "csrc" / "gather.cu").read_text()
    exported = set(re.findall(r"^int (\w+)\(", src, flags=re.M))
    assert exported == {*gather.KERNELS, "gather_bwd_chunk_slots",
                        "gather_bwd_tile_chunks"}
    n_ptr = src.split("int gather_bwd(")[1].split(")")[0].count("void*")
    assert n_ptr == sum(t is gather._P for t in gather._ARGTYPES)


def test_library_builds_stale_siblings_and_survives_their_failure(
        tmp_path, monkeypatch):
    """``_build.library(name)`` compiles the other stale .cu sources in the
    same round; a sibling that fails to compile leaves ``name`` loaded,
    and the sibling's own first call raises with the compiler's output.
    A stand-in for nvcc compiles each source as C with g++."""
    from tgb_tgn_dgl_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("good", "other", "bad"):
        (csrc / f"{name}.cu").write_text(
            f"int {name}_entry(void) {{ return 7; }}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        '#!/bin/sh\nout=""; src=""\n'
        'while [ $# -gt 0 ]; do case "$1" in -o) out="$2"; shift;; '
        '*.cu) src="$1";; esac; shift; done\n'
        'case "$src" in *bad.cu) echo "error: bad source" >&2; exit 1;; '
        'esac\nexec g++ -shared -fPIC -x c -o "$out" "$src"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    assert _build.library("good").good_entry() == 7
    assert _build.target("other").exists()
    assert not _build.target("bad").exists()
    with pytest.raises(RuntimeError, match="error: bad source"):
        _build.library("bad")


def test_import_builds_nothing():
    code = ("import tgb_tgn_dgl_tpu_torch.engine.train, chip_smoke, "
            "tgb_tgn_dgl_tpu_torch.run_tgn, "
            "tgb_tgn_dgl_tpu_torch.engine.checkpoint, "
            "tgb_tgn_dgl_tpu_torch.utils.metrics, "
            "tgb_tgn_dgl_tpu_torch.parallel.mh_engine, "
            "tgb_tgn_dgl_tpu_torch.parallel.engine, "
            "tgb_tgn_dgl_tpu_torch.parallel.mesh, "
            "tgb_tgn_dgl_tpu_torch.parallel.sharded, "
            "tgb_tgn_dgl_tpu_torch.data.tcsr, "
            "tgb_tgn_dgl_tpu_torch.data.hostops, "
            "tgb_tgn_dgl_tpu_torch.data.dependency, "
            "tgb_tgn_dgl_tpu_torch.ops.segment, "
            "tgb_tgn_dgl_tpu_torch.utils.flops, "
            "tgb_tgn_dgl_tpu_torch.utils.visualize; "
            "from tgb_tgn_dgl_tpu_torch.ops import _build; "
            "print(len(_build._loaded))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "0"
    from tgb_tgn_dgl_tpu_torch.ops import _build
    assert _build.sources() == ["attention", "gather"]
    assert _build.target("attention").parent == PKG / "_build"


def test_host_build_compiles_only_the_ports_sources(monkeypatch, tmp_path):
    """The host libraries (the t-CSR samplers and the leveler, the
    packer, the owned exchange's owners) build each from its own
    tgb_tgn_dgl_tpu_torch/csrc/<name>.cpp alone into the port's _build/,
    never from or into the JAX package's csrc/; each compile command names
    no other source."""
    from tgb_tgn_dgl_tpu_torch.ops import _build
    names = ["hostops", "owned_state", "packer"]
    assert _build.host_sources() == names
    for name in names:
        assert _build.host_target(name).parent == PKG / "_build"
        lib = _build.host_library(name)
        assert Path(lib._name).parent == PKG / "_build"
    seen = []

    def fake_run(cmd, **kw):
        seen.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build, "CXX", "c++-probe")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    for name in names:
        _build.build_host(name)
        sources = [Path(a) for a in seen[-1]
                   if a.endswith((".cpp", ".cc", ".cu"))]
        assert sources == [PKG / "csrc" / f"{name}.cpp"]
        assert _build.host_target(name).exists()
    assert len(seen) == len(names)
