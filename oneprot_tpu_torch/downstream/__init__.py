"""Downstream probes on frozen embeddings (counterpart of
oneprot_tpu/downstream/): the MLP probe on the card (`mlp_probe`), the
boosted probes on the host (`boosters`), f1_max and the task metrics in
numpy (`utils`), and the LMDB -> CSV converter (`lmdb_converter`)."""
