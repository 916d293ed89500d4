"""Knowledge-graph store, annotation normalizer and subgraph featurizer
(host-side, numpy)."""
