"""Serving on the port (``repro.launch``'s serving half, DESIGN.md §11):

  traffic    — arrival processes and request-length mixtures (numpy)
  scheduler  — continuous-batching slots, queue and token accounting
  report     — TTFT / TPOT percentiles, efficiency, SLO attainment
  simulate   — the event-driven and step-granular serving simulators and
               the fault-rate SLO curve, priced by ``imc.cost_model``
  engine     — ``ServeEngine`` (the model's prefill / decode with a KV
               cache on the card) and ``StubEngine``
  serve      — the serving loop and CLI (``python -m
               repro_torch.launch.serve``)
"""
