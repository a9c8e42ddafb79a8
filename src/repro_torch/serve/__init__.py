"""Serving: KV caches, prefill/decode steps and the continuous-batching
engine."""
