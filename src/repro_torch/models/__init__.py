"""Decoder-only model stack of the port (``repro.models``' layout), for the
model-level analog accuracy study and serving:

  common     — ParamSpec and init, the ``linear`` interception hook, norms,
               activations, rotary embeddings
  attention  — grouped-query self-attention, full-sequence and single-token
               decode against a KV cache
  ffn        — gated dense FFN
  model      — parameter tree, embedding, blocks, logits, serving (prefill,
               decode step, KV cache), and
               ``params_from_reference`` (the JAX tree as numpy -> tensors)

Parameters are plain nested dicts of tensors with the reference's tree
paths; the forward is plain functions on tensors.
"""
