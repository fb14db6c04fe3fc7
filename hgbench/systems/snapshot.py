"""``system: snapshot``: the drawn tables loaded by
``CSRSnapshot.from_tables``, read-only, for the BFS lane to run over."""


def build(cfg: dict, tables: dict):
    from hypergraphdb_tpu_torch.ops.snapshot import CSRSnapshot

    return CSRSnapshot.from_tables(tables["type_of"], tables["is_link"],
                                   tables["tgt_offsets"], tables["tgt_flat"],
                                   value_rank=tables["value_rank"])
