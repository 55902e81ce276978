"""Evaluation: cross-modal retrieval (`retrieval_eval`) and frozen
embeddings for downstream probes (`collect_embeddings`)."""
