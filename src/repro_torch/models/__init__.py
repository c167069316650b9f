"""Model stack of the port (``repro.models``' layout) for all ten archs,
for the model-level analog accuracy study and serving:

  common     — ParamSpec and init, the ``linear`` interception hook, norms,
               activations, rotary embeddings
  attention  — grouped-query self-, encoder and cross-attention,
               full-sequence and single-token decode against a KV cache
  ffn        — gated dense FFN and Mixture-of-Experts
  ssm        — Mamba-2 (chunked SSD prefill, O(1) decode recurrence)
  model      — parameter tree, embedding (with frontends), blocks, the
               encoder, logits, serving (prefill, decode step, cache), and
               ``params_from_reference`` (the JAX tree as numpy -> tensors)

Parameters are plain nested dicts of tensors with the reference's tree
paths; the forward is plain functions on tensors.
"""
