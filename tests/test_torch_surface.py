"""The port's surface is the reference's: every public top-level name (and
every public method of a public class) of each module of
``hypergraphdb_tpu`` exists in the port's module of the same path, or in
the three files the CUDA kernels replace their Pallas counterparts, or it
stands in :data:`OMITTED` with the reason the port leaves it out. Both
packages are parsed with ``ast``; neither is imported.

Names a module imports do not count, but in an ``__init__.py``, whose
imports are its exports.

The parameters too: every parameter of a public function or method (its
dunder methods included) that both files define is a parameter of the
port's (a port ``**kwargs`` takes any named one), and every field of a
dataclass both define is a field of the port's, or it stands in
:data:`OMITTED_PARAMS` with its reason."""

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
        "nothing in either package reads its fields; the port's from_dict "
        "drops the section (config.DROPPED_SECTIONS)",
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


_RANK_WORD = ("the reference splits each 64-bit value rank into uint32 "
              "hi/lo halves (jax runs without 64-bit integers); the port "
              "carries one int64 rank word")
_RANK_COLUMN = ("the port passes the ValueIndexColumn (rank, rank2 and gids "
                "as int64/int32 tensors, its real count n) and int64 bound "
                "words where the reference passes each column's uint32 "
                "halves, gids and count as separate arrays")
_INTERPRET = ("Pallas's interpret mode; a port wrapper runs its kernel's "
              "plain version on a CPU tensor and launches on a CUDA one")
_JIT = ("the jax function to lower and compile; torch has no compiled "
        "executable to cache, so the port's entry takes the function that "
        "makes the host plan (build)")
_FUSED_PLAN = ("the TPU plan's block grid (blocks of chunks a segment); "
               "K2's plan is a CUDA work-item layout (item_off, item_row, "
               "row_chunk_starts)")
_SHARD_COLUMN = ("uploaded by the reference and read by no sharded lane: "
                 "the sharded pattern lane takes types and arities from "
                 "the host snapshot (pattern_host_rows), the sharded join "
                 "from the replicated DeviceSnapshot, and the sharded BFS "
                 "reads only the edge slices")

#: (reference file, qualified name, parameter or field) -> why the port's
#: function or dataclass has no such one
OMITTED_PARAMS = {
    ("core/config.py", "HGConfiguration", "snapshot"):
        "the SnapshotConfig section, which nothing reads; the port's "
        "from_dict drops it (config.DROPPED_SECTIONS)",
    ("ops/aot_cache.py", "env_fingerprint", "backend"):
        "the jax backend name; the port keys the environment by the torch "
        "device it is given (device)",
    ("ops/aot_cache.py", "AOTCache", "backend"):
        "the jax backend name; the port's cache holds the torch device its "
        "plans are for (device)",
    ("ops/aot_cache.py", "AOTCache.get_or_compile", "jit_fn"): _JIT,
    ("ops/aot_cache.py", "AOTCache.warm", "jit_fn"): _JIT,
    ("ops/pallas_bfs.py", "FusedPlan", "blk_off"): _FUSED_PLAN,
    ("ops/pallas_bfs.py", "FusedPlan", "chunk_rows"): _FUSED_PLAN,
    ("ops/pallas_bfs.py", "overlay_plan_for", "n_atoms"):
        "the port takes the base snapshot (snap) and reads its num_atoms",
    ("ops/pallas_bfs.py", "serve_fused_kwargs", "base_snap"):
        "the same base snapshot, named snap as in the port's other "
        "functions that make plans",
    ("ops/pallas_bfs.py", "bfs_pull_fused", "interpret"): _INTERPRET,
    ("ops/pallas_gather.py", "gather_or", "interpret"): _INTERPRET,
    ("ops/serving.py", "bfs_serve_batch_fused", "fused"):
        "the device plan, named plan in the port",
    ("ops/serving.py", "bfs_serve_batch_fused", "n_atoms"):
        "the port reads it from the plan's geometry (geom.n_atoms)",
    ("ops/serving.py", "bfs_serve_batch_fused", "kwp"):
        "the TPU's 128-word lane padding of the seed words; K2 takes any "
        "word count",
    ("ops/serving.py", "bfs_serve_batch_fused", "widths1"):
        "the overlay's level widths, jit statics in the reference; the "
        "port's overlay plan carries them (DeltaOverlayPlan.widths1)",
    ("ops/serving.py", "bfs_serve_batch_fused", "widths2"):
        "the overlay's level widths, jit statics in the reference; the "
        "port's overlay plan carries them (DeltaOverlayPlan.widths2)",
    ("ops/serving.py", "bfs_serve_batch_fused", "interpret"): _INTERPRET,
    **{("ops/setops.py", "incident_value_pattern", p): _RANK_WORD
       for p in ("rank_hi", "rank_lo")},
    **{("ops/setops.py", "incident_value_range", p): _RANK_WORD
       for p in ("lo_hi", "lo_lo", "hi_hi", "hi_lo")},
    **{("ops/snapshot.py", "DeviceSnapshot", p): _RANK_WORD
       for p in ("value_rank_hi", "value_rank_lo")},
    **{("storage/value_index.py", "ValueIndexColumn", p): _RANK_WORD
       for p in ("rank_hi", "rank_lo", "rank2_hi", "rank2_lo")},
    **{("ops/value_index.py", "range_probe_batch", p): _RANK_COLUMN
       for p in ("col_hi", "col_lo", "col_hi2", "col_lo2", "n_real",
                 "lo_hi", "lo_lo", "lo_hi2", "lo_lo2",
                 "hi_hi", "hi_lo", "hi_hi2", "hi_lo2")},
    **{("ops/value_index.py", "ordered_topk_batch", p): _RANK_COLUMN
       for p in ("col_hi", "col_lo", "col_hi2", "col_lo2", "col_gid",
                 "n_base", "d_hi", "d_lo", "d_hi2", "d_lo2", "d_gid",
                 "n_delta", "lo_hi", "lo_lo", "lo_hi2", "lo_lo2",
                 "hi_hi", "hi_lo", "hi_hi2", "hi_lo2")},
    **{("parallel/sharded.py", "ShardedSnapshot", p): _RANK_WORD
       for p in ("value_rank_hi", "value_rank_lo")},
    **{("parallel/sharded.py", "ShardedSnapshot", p): _SHARD_COLUMN
       for p in ("type_of", "is_link", "arity")},
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


def _public(qual: str) -> bool:
    """No part of the name is private (a dunder method is public)."""
    return not any(p.startswith("_") and not (p.startswith("__")
                                              and p.endswith("__"))
                   for p in qual.split("."))


def _is_dataclass(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        t = d.func if isinstance(d, ast.Call) else d
        if (t.attr if isinstance(t, ast.Attribute)
                else getattr(t, "id", None)) == "dataclass":
            return True
    return False


def parameters(path: Path) -> dict:
    """Qualified name -> parameter names of every public function and
    method of one file (``self`` and ``cls`` left out; ``*args`` as
    ``*args``, ``**kw`` as ``**kw``), and, for each dataclass, its name ->
    its field names."""
    tree = ast.parse(path.read_text())
    out = {}

    def params(fn) -> set:
        a = fn.args
        names = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}
        if a.vararg:
            names.add("*" + a.vararg.arg)
        if a.kwarg:
            names.add("**" + a.kwarg.arg)
        return names - {"self", "cls"}

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{m.name}"] = params(m)
            if _is_dataclass(node):
                out[node.name] = {m.target.id for m in node.body
                                  if isinstance(m, ast.AnnAssign)
                                  and isinstance(m.target, ast.Name)}
    return {q: v for q, v in out.items() if _public(q)}


def missing_params(rel: str) -> list:
    """``(qualified name, parameter)`` of the reference file that the
    port's counterpart defines without that parameter or field, and
    :data:`OMITTED_PARAMS` does not excuse."""
    ref, port = parameters(REF / rel), parameters(port_file(rel))
    out = []
    for qual, names in ref.items():
        have = port.get(qual)
        if have is None:
            continue  # a missing name is test_port_module_has_...'s
        takes_any = any(n.startswith("**") for n in have)
        out.extend((qual, n) for n in names
                   if n not in have
                   and not (takes_any and not n.startswith("*"))
                   and (rel, qual, n) not in OMITTED_PARAMS)
    return sorted(out)


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


@pytest.mark.parametrize("rel", reference_files())
def test_port_signatures_take_the_reference_parameters(rel):
    assert port_file(rel).exists(), f"no port of {rel}"
    assert missing_params(rel) == []


def test_omissions_name_real_gaps_with_reasons():
    """Each omission is a name the reference has and the port lacks, with
    a reason of some length."""
    for (rel, name), why in OMITTED.items():
        assert name in public_names(REF / rel), (rel, name)
        assert name not in public_names(port_file(rel)), (rel, name)
        assert len(why) > 20, (rel, name)


def test_parameter_omissions_name_real_gaps_with_reasons():
    """Each parameter omission is one the reference has and the port's
    counterpart lacks, with a reason of some length."""
    for (rel, qual, name), why in OMITTED_PARAMS.items():
        ref, port = parameters(REF / rel), parameters(port_file(rel))
        assert name in ref.get(qual, ()), (rel, qual, name)
        assert qual in port and name not in port[qual], (rel, qual, name)
        assert len(why) > 20, (rel, qual, name)


def test_guard_sees_a_gap():
    """The parse finds what the guard holds the port to: names defined
    (and imported, in an ``__init__``) and methods of classes."""
    ops_init = public_names(PORT / "ops/__init__.py")
    assert {"CSRSnapshot", "bfs_pull_fused", "SnapshotManager"} <= ops_init
    assert "IntType.subsumes" in public_names(PORT / "types/primitive.py")
    assert "np" not in public_names(PORT / "ops/frontier.py")
    assert "verify.py" in reference_files()


def test_parameter_guard_sees_a_gap():
    """The parse reads the parameters of methods (``__init__`` included)
    and the fields of dataclasses, and the comparison names a parameter
    the port would lack."""
    storage = parameters(PORT / "storage/partitioned.py")
    assert {"partitions", "n_partitions", "factory",
            "partition_map"} == storage["PartitionedStorage.__init__"]
    assert "PartitionMap" in storage and "n_parts" in storage["PartitionMap"]
    serve = parameters(PORT / "serve/runtime.py")["ServeConfig"]
    assert {"buckets", "prewarm_pattern_arities", "device"} <= serve
    assert "ServeConfig.__init__" not in parameters(PORT / "serve/runtime.py")
    assert parameters(PORT / "atom/utilities.py")["add_rel"] == {
        "graph", "rel_type", "*targets"}
    ref = parameters(REF / "storage/partitioned.py")
    storage["PartitionedStorage.__init__"].discard("partition_map")
    assert ("PartitionedStorage.__init__", "partition_map") in [
        (q, n) for q, names in ref.items() for n in names
        if n not in storage.get(q, names)]
