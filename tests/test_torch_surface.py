"""The port's surface is the reference's: every public top-level name (and
every public method of a public class) of each module of
``hypergraphdb_tpu`` exists in the port's module of the same path, or in
the three files the CUDA kernels replace their Pallas counterparts, or it
stands in :data:`OMITTED` with the reason the port leaves it out. Both
packages are parsed with ``ast``; neither is imported.

Names a module imports do not count, but in an ``__init__.py``, whose
imports are its exports."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "hypergraphdb_tpu"
PORT = ROOT / "hypergraphdb_tpu_torch"

#: the Pallas files and the port modules that hold their CUDA kernels'
#: wrappers
KERNEL_FILES = {
    "ops/pallas_gather.py": "ops/gather_or.py",
    "ops/pallas_bfs.py": "ops/fused_bfs.py",
    "ops/pallas_kernels.py": "ops/membership.py",
}

_TPU_TILING = ("a Pallas grid, VMEM or SMEM sizing constant of the TPU "
               "kernel; the CUDA kernel fixes its own launch shape")

#: (reference file, name) -> why the port has no such name
OMITTED = {
    ("verify.py", "sds"):
        "the jax.ShapeDtypeStruct shorthand; torch has no abstract shape "
        "that data-dependent ops run on, so the port's exemplars are small "
        "concrete tensors (verify.tensor, ints, words)",
    ("core/config.py", "SnapshotConfig"):
        "nothing in either package reads it",
    ("storage/partitioned.py", "PartitionedStorage.repartition"):
        "no caller in either package",
    ("storage/memstore.py", "MemStorage.iter_record_handles"):
        "only PartitionedStorage.repartition calls it",
    ("ops/__init__.py", "pallas_bfs_ok"):
        "reads HG_PALLAS_BFS to gate the Pallas kernel; the port's K2 is "
        "never gated: on a CUDA tensor it launches or raises",
    ("query/compiler.py", "logger"):
        "a module-level logger; the port logs through named loggers where "
        "it logs",
    ("join/planner.py", "logger"):
        "a module-level logger; the port logs through named loggers where "
        "it logs",
    ("native/__init__.py", "SO"):
        "the path of the reference's library beside its source; the port "
        "builds its engine into build/native/ under a content hash",
    ("ops/pallas_gather.py", "D"): _TPU_TILING,
    ("ops/pallas_gather.py", "G"): _TPU_TILING,
    ("ops/pallas_gather.py", "SEG"): _TPU_TILING,
    ("ops/pallas_gather.py", "MIN_INDICES"): _TPU_TILING,
    ("ops/pallas_gather.py", "SMEM_BUDGET"): _TPU_TILING,
    ("ops/pallas_gather.py", "VMEM_BUDGET"): _TPU_TILING,
    ("ops/pallas_gather.py", "pallas_ok"):
        "gates the Pallas route; K1 on a CUDA tensor launches or raises",
    ("ops/pallas_bfs.py", "B"): _TPU_TILING,
    ("ops/pallas_bfs.py", "CHUNK"): _TPU_TILING,
    ("ops/pallas_bfs.py", "D"): _TPU_TILING,
    ("ops/pallas_bfs.py", "KWP_MIN"):
        "the TPU's 128-word lane padding of the seed words; K2 takes any "
        "word count",
    ("ops/pallas_bfs.py", "SEG_BLOCKS"): _TPU_TILING,
    ("ops/pallas_bfs.py", "SMEM_BUDGET"): _TPU_TILING,
    ("ops/pallas_bfs.py", "VMEM_BUDGET"): _TPU_TILING,
    ("ops/pallas_bfs.py", "FusedPlan.smem_ok"):
        "checks the plan against the TPU's scalar memory; the port's plan "
        "has no such bound (plan_supported checks its index budget)",
    ("ops/pallas_bfs.py", "pallas_bfs_ok"):
        "reads HG_PALLAS_BFS to gate the Pallas kernel; the port's K2 is "
        "never gated",
    ("ops/pallas_bfs.py", "WORD"):
        "the word width is ops/ellbfs.WORD, which the port's fused module "
        "imports",
    ("ops/pallas_bfs.py", "EXEMPLAR_GEOM"):
        "the abstract plan geometry the JAX tracer needs; the port's "
        "exemplar is a concrete plan (verify.fused_args)",
    ("ops/pallas_bfs.py", "exemplar_shapes"):
        "the abstract exemplar the JAX tracer needs; the port's is "
        "verify.fused_args",
    ("ops/pallas_kernels.py", "SENTINEL"):
        "the pad value is ops/setops.SENTINEL, which the port's kernel "
        "module imports",
    ("ops/pallas_kernels.py", "fits_vmem"): _TPU_TILING,
    ("ops/pallas_kernels.py", "membership_mask_pallas"):
        "K3's padded entry is ops/membership.membership_mask",
    ("ops/pallas_kernels.py", "intersect_sorted_pallas"):
        "K3's sorted intersection is ops/setops.device_intersect_sorted, "
        "through membership_mask_ragged",
}


def public_names(path: Path) -> set:
    """Public top-level functions, classes with their public methods and
    assigned names of one file; imported names only in an ``__init__``."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif (isinstance(node, (ast.Import, ast.ImportFrom))
              and path.name == "__init__.py"):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return {n for n in out if not any(p.startswith("_")
                                      for p in n.split("."))}


def reference_files() -> list:
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def port_file(rel: str) -> Path:
    return PORT / KERNEL_FILES.get(rel, rel)


def missing(rel: str) -> list:
    """The reference file's public names the port's counterpart lacks and
    the omission list does not excuse."""
    have = public_names(port_file(rel))
    return sorted(n for n in public_names(REF / rel)
                  if n not in have and (rel, n) not in OMITTED)


@pytest.mark.parametrize("rel", reference_files())
def test_port_module_has_the_reference_surface(rel):
    assert port_file(rel).exists(), f"no port of {rel}"
    assert missing(rel) == []


def test_omissions_name_real_gaps_with_reasons():
    """Each omission is a name the reference has and the port lacks, with
    a reason of some length."""
    for (rel, name), why in OMITTED.items():
        assert name in public_names(REF / rel), (rel, name)
        assert name not in public_names(port_file(rel)), (rel, name)
        assert len(why) > 20, (rel, name)


def test_guard_sees_a_gap():
    """The parse finds what the guard holds the port to: names defined
    (and imported, in an ``__init__``) and methods of classes."""
    ops_init = public_names(PORT / "ops/__init__.py")
    assert {"CSRSnapshot", "bfs_pull_fused", "SnapshotManager"} <= ops_init
    assert "IntType.subsumes" in public_names(PORT / "types/primitive.py")
    assert "np" not in public_names(PORT / "ops/frontier.py")
    assert "verify.py" in reference_files()
