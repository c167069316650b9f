"""The program's own configuration of a model, held to the benchmark's
configuration file (a run refuses to start where the two disagree), and
the numbers a check compares."""

MISSING = 1e30          # the value of a compared number that was not read


def program_arch(run):
    """The program's configuration of the file's model, held to the
    file's sizes."""
    from repro_torch.configs import registry

    cfg = registry.get_arch(run.config["program_arch"])
    c = run.config
    want = dict(d_model=c["hidden_size"], n_layers=c["num_hidden_layers"],
                n_heads=c["num_attention_heads"],
                n_kv_heads=c["num_key_value_heads"],
                d_head=c.get("head_dim", c["hidden_size"]
                             // c["num_attention_heads"]),
                vocab=c["vocab_size"], tie_embeddings=c["tie_word_embeddings"],
                compute_dtype=c["precision"]["compute_dtype"],
                param_dtype=c["precision"]["param_dtype"],
                norm_eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
                qkv_bias=c["qkv_bias"], qk_norm=c["qk_norm"])
    got = {k: getattr(cfg, k, None) for k in want}
    for k in ("rope_theta", "qkv_bias", "qk_norm"):
        got[k] = getattr(cfg.attn, k)
    if c.get("num_experts"):
        want.update(experts=c["num_experts"], top_k=c["num_experts_per_tok"],
                    ffn=c["intermediate_size"])
        got.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   ffn=cfg.moe.d_expert)
    else:
        want["ffn"] = c["intermediate_size"]
        got["ffn"] = cfg.d_ff
    if got != want:
        raise ValueError(f"the program's {cfg.name} is not the configuration "
                         f"file's: {got} != {want}")
    return cfg


def compared(run, numbers: dict) -> dict:
    """The numbers the cell's limits name (``checks/<cell>.json``), each
    with its limit; the others go to the earlier lines."""
    limits = run.cell.limits()
    for name, value in numbers.items():
        if name not in limits:
            run.info[f"not compared: {name}"] = value
    return {name: {"value": numbers.get(name, MISSING), "limit": limit}
            for name, limit in limits.items()}
