"""Decoder-only model stack of the port (``repro.models``' layout), for the
model-level analog accuracy study:

  common     — ParamSpec and init, the ``linear`` interception hook, norms,
               activations, rotary embeddings
  attention  — full-sequence grouped-query self-attention
  ffn        — gated dense FFN
  model      — parameter tree, embedding, blocks, logits, and
               ``params_from_reference`` (the JAX tree as numpy -> tensors)

Parameters are plain nested dicts of tensors with the reference's tree
paths; the forward is plain functions on tensors.
"""
