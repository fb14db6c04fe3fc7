"""Port snapshot vs the reference: the same tables give the same columns,
``from_reference_arrays`` carries a reference snapshot across exactly, and
``dbpedia_snapshot`` gives identical arrays for the same seed. Tolerance:
exact equality."""

import numpy as np
import pytest
import torch

from hypergraphdb_tpu.models.generators import dbpedia_snapshot as jax_dbpedia
from hypergraphdb_tpu.ops.snapshot import CSRSnapshot as JaxSnapshot
from hypergraphdb_tpu_torch.models import dbpedia_snapshot
from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot, DeviceSnapshot
from tests.test_ellbfs import random_snapshot

FIELDS = CSRSnapshot.REFERENCE_FIELDS


def to_port(snap_ref) -> CSRSnapshot:
    """The reference snapshot carried into the port."""
    return CSRSnapshot.from_reference_arrays(
        {k: getattr(snap_ref, k) for k in FIELDS})


def assert_same_topology(a, b):
    for k in FIELDS:
        va, vb = getattr(a, k), getattr(b, k)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, k
            assert np.array_equal(va, vb), k
        else:
            assert va == vb, k
    assert a.by_type.keys() == b.by_type.keys()
    for t in a.by_type:
        assert np.array_equal(a.by_type[t], b.by_type[t])


@pytest.mark.parametrize("zipf", [False, True])
def test_from_tables_matches_reference(zipf):
    r = np.random.default_rng(3)
    n_nodes, n_links = 120, 90
    N = n_nodes + n_links
    type_of = r.integers(0, 4, size=N).astype(np.int32)
    type_of[5] = -1
    is_link = np.zeros(N, dtype=bool)
    is_link[n_nodes:] = True
    arities = r.integers(1, 6, size=n_links)
    offsets = np.zeros(N + 1, dtype=np.int64)
    offsets[n_nodes + 1 :] = np.cumsum(arities)
    if zipf:
        flat = r.zipf(1.3, size=int(arities.sum())) % N
    else:
        flat = r.integers(0, N, size=int(arities.sum()))
    ref = JaxSnapshot.from_tables(type_of, is_link, offsets, flat)
    port = CSRSnapshot.from_tables(type_of, is_link, offsets, flat)
    assert_same_topology(ref, port)


def test_from_reference_arrays_copies_exactly():
    ref = random_snapshot(200, 150, 5, seed=4, zipf=True)
    port = to_port(ref)
    assert_same_topology(ref, port)
    port.inc_links[0] += 1  # the two share no memory
    assert port.inc_links[0] != ref.inc_links[0]


def test_from_reference_arrays_rejects_bad_columns():
    ref = random_snapshot(20, 10, 3, seed=1)
    d = {k: getattr(ref, k) for k in FIELDS}
    with pytest.raises(KeyError):
        CSRSnapshot.from_reference_arrays(
            {k: v for k, v in d.items() if k != "inc_src"})
    d["inc_offsets"] = d["inc_offsets"][:-1]
    with pytest.raises(ValueError, match="inc_offsets"):
        CSRSnapshot.from_reference_arrays(d)


def test_dbpedia_snapshot_same_arrays_as_reference():
    ref, ref_info = jax_dbpedia(n_entities=300, n_links=900, seed=5)
    port, info = dbpedia_snapshot(n_entities=300, n_links=900, seed=5)
    assert_same_topology(ref, port)
    assert info == ref_info


def test_device_snapshot_on_cpu():
    port = to_port(random_snapshot(30, 20, 3, seed=2))
    dev = DeviceSnapshot.from_host(port, device="cpu")
    assert dev.num_atoms == port.num_atoms
    assert torch.equal(dev.inc_links, torch.from_numpy(port.inc_links))
    assert dev.to("cpu").tgt_flat.device.type == "cpu"
