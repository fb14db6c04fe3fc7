from hypergraphdb_tpu_torch.models.generators import (
    Entity,
    Synset,
    dbpedia_like,
    dbpedia_snapshot,
    wordnet_like,
    zipf_hypergraph,
)

__all__ = ["Entity", "Synset", "dbpedia_like", "dbpedia_snapshot",
           "wordnet_like", "zipf_hypergraph"]
