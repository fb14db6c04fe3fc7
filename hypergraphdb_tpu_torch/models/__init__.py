from hypergraphdb_tpu_torch.models.generators import dbpedia_snapshot

__all__ = ["dbpedia_snapshot"]
