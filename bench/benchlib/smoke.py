"""Smoke-size cells for the CPU tests: the program's smoke configuration
of a model (``repro_torch.configs.registry.smoke_config``) written into the
benchmark's configuration file, and the traffic cut to a few positions."""
from __future__ import annotations

import copy

from benchlib.registry import Cell


def smoke_cell(name: str, traffic: dict | None = None,
               train: dict | None = None) -> Cell:
    from repro_torch.configs.registry import smoke_config

    cell = Cell(name)
    conf = copy.deepcopy(cell.config)
    c = smoke_config(conf["program_arch"])
    conf.update(hidden_size=c.d_model, num_hidden_layers=c.n_layers,
                num_attention_heads=c.n_heads,
                num_key_value_heads=c.n_kv_heads, head_dim=c.d_head,
                intermediate_size=(c.moe.d_expert if c.moe else c.d_ff),
                vocab_size=c.vocab)
    conf["precision"] = dict(conf["precision"],
                             compute_dtype=c.compute_dtype,
                             param_dtype=c.param_dtype)
    if c.moe:
        conf.update(num_experts=c.moe.num_experts,
                    num_experts_per_tok=c.moe.top_k)
    if "train_4k" in conf:
        conf["train_4k"] = dict(conf["train_4k"], **(train or {}))
    cell.config = conf
    cell.traffic = dict(cell.traffic, **(traffic or {}))
    return cell


def patch_program(monkeypatch) -> None:
    """The program's registry answers with the smoke configurations."""
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "get_arch", smoke_configs().__getitem__)


def smoke_configs() -> dict:
    from repro_torch.configs import registry

    return {n: registry.smoke_config(n) for n in registry.ARCHS}
