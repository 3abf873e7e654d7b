"""The weights both sides are given, made on the device from the seed.

The layout is the port's parameter tree (names, and each layer's leaves
stacked on a leading layer axis), written here from the configuration's
sizes; a CPU test holds it equal to ``repro_torch``'s ``param_shapes``.
Every leaf is one ``randn`` call on the device in the served dtype:
matrices, embedding and router N(0, initializer_range), q/k/v biases the
same, norm gains 1 + N(0, initializer_range).
"""

from __future__ import annotations

import torch

from portbench.spec import subseed


def sizes(conf: dict) -> dict:
    """The sizes the layout needs, from a configuration file."""
    d = conf["hidden_size"]
    h = conf["num_attention_heads"]
    out = {"d": d, "h": h, "kh": conf["num_key_value_heads"],
           "L": conf["num_hidden_layers"], "V": conf["vocab_size"],
           "mla": conf["model_type"] == "deepseek_v2",
           "eps": conf["rms_norm_eps"], "theta": float(conf["rope_theta"])}
    if out["mla"]:
        out.update(hd=conf["qk_nope_head_dim"], dr=conf["qk_rope_head_dim"],
                   dv=conf["v_head_dim"], r=conf["kv_lora_rank"],
                   E=conf["n_routed_experts"], k=conf["num_experts_per_tok"],
                   fe=conf["moe_intermediate_size"],
                   fs=conf["moe_intermediate_size"] * conf["n_shared_experts"],
                   renorm=bool(conf["norm_topk_prob"]))
    else:
        out.update(hd=d // h, f=conf["intermediate_size"])
    return out


def layout(conf: dict) -> dict:
    """``{name: shape}`` of the top-level leaves and ``{"layers": {name:
    [L, ...]}}`` of the stacked per-layer leaves."""
    s = sizes(conf)
    d, h, kh, hd, L, V = s["d"], s["h"], s["kh"], s["hd"], s["L"], s["V"]
    lay = {"ln1_g": (d,), "ln2_g": (d,)}
    if s["mla"]:
        r, dr, fe, fs, E = s["r"], s["dr"], s["fe"], s["fs"], s["E"]
        lay.update(wq=(d, h * (hd + dr)), wdkv=(d, r + dr),
                   wuk=(r, kh * hd), wuv=(r, kh * s["dv"]),
                   wo=(h * s["dv"], d), router=(d, E),
                   ew1=(E, d, fe), ew3=(E, d, fe), ew2=(E, fe, d),
                   sw1=(d, fs), sw3=(d, fs), sw2=(fs, d))
    else:
        f = s["f"]
        lay.update(wq=(d, h * hd), wk=(d, kh * hd), wv=(d, kh * hd),
                   bq=(h * hd,), bk=(kh * hd,), bv=(kh * hd,),
                   wo=(h * hd, d), w1=(d, f), w3=(d, f), w2=(f, d))
    top = {"embed": (V, d), "lnf_g": (d,)}
    if not conf.get("tie_word_embeddings", False):
        top["head"] = (d, V)
    top["layers"] = {k: (L, *v) for k, v in lay.items()}
    return top


def _gains(name: str) -> bool:
    return name.endswith("_g")


def make(conf: dict, seed: int, device, dtype=None) -> dict:
    """The parameter tree of ``conf`` from ``seed``, on ``device`` in
    ``dtype`` (default: the file's ``torch_dtype``)."""
    dtype = dtype or getattr(torch, conf["torch_dtype"])
    std = float(conf["initializer_range"])
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "weights"))

    def leaf(name, shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        t.mul_(std)
        if _gains(name):
            t.add_(1.0)
        return t

    tree = layout(conf)
    out = {}
    for name in sorted(tree):
        if name == "layers":
            continue
        out[name] = leaf(name, tree[name])
    out["layers"] = {name: leaf(name, shape)
                     for name, shape in sorted(tree["layers"].items())}
    return out


def named_leaves(tree: dict):
    """``(name, tensor)`` of every top-level leaf and of every layer's
    slice of a stacked leaf (``layers.<name>.<i>``), in a fixed order."""
    for name in sorted(tree):
        if name != "layers":
            yield name, tree[name]
    for name in sorted(tree["layers"]):
        stacked = tree["layers"][name]
        for i in range(stacked.shape[0]):
            yield f"layers.{name}.{i}", stacked[i]
