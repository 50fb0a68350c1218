"""The shape of a configuration, read from its file's published keys (the
reference's own reading; nothing of the program). Where the port departs
from the published model, the file's ``as_run`` names the values it runs
(listed in its ``assumed``), and they are read in their keys' place."""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Arch:
    d: int
    heads: int
    kv_heads: int
    hd: int
    layers: int
    vocab: int
    d_ff: int
    experts: int = 0
    top_k: int = 0
    moe_ff: int = 0
    shared: int = 0
    first_dense: int = 0
    qk_norm: bool = False
    rope_theta: float = 10000.0
    eps: float = 1e-6
    norm_topk: bool = True
    aux_alpha: float = 0.0
    capacity_factor: float = 1.25  # the repo's MoE capacity (slots an expert)
    tied: bool = False  # the head is the embedding, transposed

    @classmethod
    def from_config(cls, c: dict) -> "Arch":
        c = {**c, **c.get("as_run", {})}
        heads = c["num_attention_heads"]
        return cls(
            d=c["hidden_size"], heads=heads, kv_heads=c.get("num_key_value_heads", heads),
            hd=c.get("head_dim") or c["hidden_size"] // heads, layers=c["num_hidden_layers"],
            vocab=c["vocab_size"], d_ff=c.get("intermediate_size", 0),
            experts=c.get("n_routed_experts") or 0, top_k=c.get("num_experts_per_tok") or 0,
            moe_ff=c.get("moe_intermediate_size") or 0, shared=c.get("n_shared_experts") or 0,
            first_dense=c.get("first_k_dense_replace", 0) if c.get("n_routed_experts") else 0,
            qk_norm=c.get("model_type") == "qwen3", rope_theta=float(c["rope_theta"]),
            eps=float(c.get("rms_norm_eps", 1e-6)), norm_topk=bool(c.get("norm_topk_prob", True)),
            aux_alpha=float(c.get("aux_loss_alpha", 0.0)),
            tied=bool(c.get("tie_word_embeddings", False)),
        )

    def is_moe(self, layer: int) -> bool:
        return self.experts > 0 and layer >= self.first_dense

    def capacity(self, n_tokens: int) -> int:
        return max(1, int(self.capacity_factor * n_tokens * self.top_k / self.experts))

    @property
    def embed_scale(self) -> float:
        return math.sqrt(self.d)

    def leaves(self) -> list:
        """(name, shape, fan-in or None for a norm scale of ones), in a
        fixed order: the parameters of the configuration."""
        D, Q, KV = self.d, self.heads * self.hd, self.kv_heads * self.hd
        out = [("embed", (self.vocab, D), D), ("final_norm.scale", (D,), None)]
        if not self.tied:
            out.append(("lm_head", (D, self.vocab), D))
        for i in range(self.layers):
            p = f"layers.{i}."
            out += [(p + "ln1.scale", (D,), None), (p + "ln2.scale", (D,), None),
                    (p + "mix.w_q", (D, Q), D), (p + "mix.w_k", (D, KV), D),
                    (p + "mix.w_v", (D, KV), D), (p + "mix.w_o", (Q, D), Q)]
            if self.qk_norm:
                out += [(p + "mix.q_norm", (self.hd,), None), (p + "mix.k_norm", (self.hd,), None)]
            if self.is_moe(i):
                E, F = self.experts, self.moe_ff
                out += [(p + "ffn.router", (D, E), D), (p + "ffn.we1", (E, D, F), D),
                        (p + "ffn.we3", (E, D, F), D), (p + "ffn.we2", (E, F, D), F)]
                if self.shared:
                    S = F * self.shared
                    out += [(p + "ffn.shared.w1", (D, S), D), (p + "ffn.shared.w3", (D, S), D),
                            (p + "ffn.shared.w2", (S, D), S)]
            else:
                out += [(p + "ffn.w1", (D, self.d_ff), D), (p + "ffn.w3", (D, self.d_ff), D),
                        (p + "ffn.w2", (self.d_ff, D), self.d_ff)]
        return out

    def n_params(self) -> int:
        return sum(math.prod(s) for _, s, _ in self.leaves())
