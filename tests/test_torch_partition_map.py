"""The port's ``storage/partitioned.PartitionMap`` against the
reference's, after the five map cases of
``tests/test_partitioned_storage.py``: ranges that cover and align, the
sharded snapshot's row split, total clamped ownership, the vectorized
owner, the wire shape. Every map is built in both packages and compared
field by field.

Tolerance: exact equality."""

import numpy as np
import pytest

from hypergraphdb_tpu.storage.partitioned import PartitionMap as RefMap
from hypergraphdb_tpu_torch.storage.partitioned import PartitionMap


def both(capacity, n_parts):
    ref, port = (RefMap.for_mesh(capacity, n_parts),
                 PartitionMap.for_mesh(capacity, n_parts))
    assert (port.n_parts, port.part_size, port.capacity) == (
        ref.n_parts, ref.part_size, ref.capacity)
    assert port.ranges() == ref.ranges()
    return port


def test_partition_map_ranges_cover_and_align():
    pm = both(1000, 4)
    assert pm.part_size % PartitionMap.ALIGN == 0
    assert PartitionMap.ALIGN == RefMap.ALIGN == 128
    ranges = pm.ranges()
    assert ranges[0][0] == 0
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
    assert ranges[-1][1] >= pm.capacity


def test_partition_map_matches_sharded_snapshot_layout():
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot
    from hypergraphdb_tpu_torch.core.graph import HyperGraph
    from hypergraphdb_tpu_torch.parallel import ShardedSnapshot, make_mesh

    for n_dev in (1, 2, 4, 8):
        for n_atoms in (7, 127, 128, 1000, 99_999):
            pm = both(n_atoms + 1, n_dev)
            assert pm.part_size == -(-(n_atoms + 1) // (n_dev * 128)) * 128
    g = HyperGraph()
    try:
        g.add_link([g.add("a"), g.add("b")])
        snap = CSRSnapshot.pack(g)
    finally:
        g.close()
    for n_dev in (1, 3, 8):
        sdev = ShardedSnapshot.from_host(snap, make_mesh(["cpu"] * n_dev))
        assert sdev.partition_map == both(snap.num_atoms + 1, n_dev)


def test_partition_map_owner_total_and_clamped():
    pm, ref = both(512, 4), RefMap.for_mesh(512, 4)
    for gid in range(0, 2 * pm.n_parts * pm.part_size, 37):
        own = pm.owner_of(gid)
        assert own == ref.owner_of(gid) and 0 <= own < pm.n_parts
        lo, hi = pm.range_of(own)
        if own < pm.n_parts - 1:
            assert lo <= gid < hi
        else:
            assert gid >= lo
    with pytest.raises(ValueError):
        pm.owner_of(-1)
    with pytest.raises(ValueError):
        PartitionMap.for_mesh(10, 0)


def test_partition_map_owner_np_agrees_with_scalar():
    pm = both(777, 3)
    gids = np.arange(0, 3000, 13)
    vec = pm.owner_np(gids)
    assert list(vec) == [pm.owner_of(int(g)) for g in gids]
    np.testing.assert_array_equal(vec, RefMap.for_mesh(777, 3).owner_np(gids))


def test_partition_map_to_dict_wire_shape():
    d = both(400, 2).to_dict()
    assert d == RefMap.for_mesh(400, 2).to_dict()
    assert set(d) == {"n_parts", "part_size", "capacity", "ranges"}
    assert len(d["ranges"]) == 2 and d["ranges"][0][0] == 0
    assert (PartitionMap.for_mesh(400, 2).repartitioned(5000).to_dict()
            == RefMap.for_mesh(400, 2).repartitioned(5000).to_dict())
