"""The dense-GQA and MoE decoder of the repo, in plain float32 PyTorch.

The equations, as the repo writes them (departures from the published
models are listed in each configuration file's ``assumed``):

* x0 = embed[token] * sqrt(D); per layer x += attn(rms(x)); x += ffn(rms(x));
  logits = rms(x) @ lm_head, or @ embed^T where the head is tied. RMSNorm:
  x * rsqrt(mean(x^2) + eps) * scale.
* attention: q, k, v = h @ w_q, h @ w_k, h @ w_v in heads of ``hd``; with
  qk-norm an RMSNorm over each head's ``hd`` before RoPE; RoPE on
  interleaved pairs (theta ** (-2i / hd)); causal softmax(q k / sqrt(hd)) v,
  query head h reading KV head h // (H / KV); the heads' outputs @ w_o.
* dense FFN: (silu(h @ w1) * (h @ w3)) @ w2.
* MoE FFN over the N tokens of a call: p = softmax(h @ router) in float32;
  the top-k experts by a stable descending sort; gates = the k
  probabilities over their sum; each expert keeps int(1.25 N k / E) slots,
  filled in (token, pick) order, and a pick past them adds nothing; the
  output is the gated sum of the experts' SwiGLUs plus the shared experts'
  SwiGLU (one of width ``shared * moe_ff``). Aux loss (training): E *
  sum_e mean_n p[n, e] * share of tokens with e among their picks.

Every product is float32 with TF32 off. ``fp8=True`` is the control: every
matrix product's inputs (and attention's q, k, v) rounded to float8 e4m3,
a scale a tensor for weights and a row for activations, straight through
in the backward.

Parameters are held as the configuration states them (bfloat16) and
upcast at each use; in training the updated parameters are rounded to
bfloat16, as the configuration stores them, and all else is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0
ATTN_BLOCK = 1024  # query rows a block of the blocked attention
ROW_CHUNK = 8192  # rows a chunk of the dense FFN and the head


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x, per_row: bool):
    """x rounded to float8 e4m3 under a scale of max|x| / 448 (per tensor or
    per row of the last axis), with an identity gradient."""
    xd = x.detach()
    amax = xd.abs().amax(dim=-1, keepdim=True) if per_row else xd.abs().amax()
    s = amax.clamp_min(1e-12) / FP8_MAX
    xq = (xd / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (xq - xd)


def rope_tables(S: int, hd: int, theta: float, device):
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]  # (S, 1, hd/2)


def rope(x, tables):
    cos, sin = tables
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def _scores(qb, k, scale):
    return torch.einsum("bsgrd,btgd->bgrst", qb, k) * scale


def _mask(scores, s0):
    S, T = scores.shape[-2:]
    qpos = torch.arange(s0, s0 + S, device=scores.device)[:, None]
    kpos = torch.arange(T, device=scores.device)[None, :]
    return scores.masked_fill(kpos > qpos, -math.inf)


class CausalAttention(torch.autograd.Function):
    """softmax(q k / sqrt(hd)) v, causal, over blocks of ATTN_BLOCK queries
    (each against the keys it sees); the backward recomputes each block's
    probabilities from the saved log-sum-exp. q (B, S, KV, G, hd); k, v
    (B, S, KV, hd); float32."""

    @staticmethod
    def forward(ctx, q, k, v):
        B, S, KV, G, hd = q.shape
        scale = 1.0 / math.sqrt(hd)
        o = torch.empty_like(q)
        lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
        for s0 in range(0, S, ATTN_BLOCK):
            s1 = min(S, s0 + ATTN_BLOCK)
            sc = _mask(_scores(q[:, s0:s1], k[:, :s1], scale), s0)
            m = torch.logsumexp(sc, dim=-1)
            p = torch.exp(sc - m[..., None])
            o[:, s0:s1] = torch.einsum("bgrst,btgd->bsgrd", p, v[:, :s1])
            lse[..., s0:s1] = m
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        S, hd = q.shape[1], q.shape[-1]
        scale = 1.0 / math.sqrt(hd)
        dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
        delta = torch.einsum("bsgrd,bsgrd->bgrs", do, o)
        for s0 in range(0, S, ATTN_BLOCK):
            s1 = min(S, s0 + ATTN_BLOCK)
            sc = _mask(_scores(q[:, s0:s1], k[:, :s1], scale), s0)
            p = torch.exp(sc - lse[..., s0:s1, None])
            dob = do[:, s0:s1]
            dv[:, :s1] += torch.einsum("bgrst,bsgrd->btgd", p, dob)
            dp = torch.einsum("bsgrd,btgd->bgrst", dob, v[:, :s1])
            ds = p * (dp - delta[..., s0:s1, None]) * scale
            dq[:, s0:s1] = torch.einsum("bgrst,btgd->bsgrd", ds, k[:, :s1])
            dk[:, :s1] += torch.einsum("bgrst,bsgrd->btgd", ds, q[:, s0:s1])
        return dq, dk, dv


class Model:
    """The reference over the weights ``W`` (name -> tensor, any float dtype,
    upcast to float32 at each use). ``live`` holds float32 leaves that
    stand in for named weights (training differentiates through them)."""

    def __init__(self, arch, W: dict, fp8: bool = False):
        self.a, self.W, self.fp8 = arch, W, fp8
        self.live: dict = {}
        self.dropped: list = []  # picks past capacity, an MoE layer a call

    def w(self, name):
        t = self.live.get(name)
        return t if t is not None else self.W[name].float()

    def mm(self, x, name):
        return self._mm(x, self.w(name))

    def _mm(self, x, w):
        if self.fp8:
            return fp8_round(x, True) @ fp8_round(w, False)
        return x @ w

    def rms(self, x, name):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + self.a.eps) * self.w(name)

    def embed(self, tokens):
        return self.W["embed"][tokens].float() * self.a.embed_scale

    def _head_norm(self, v, name):
        return v * torch.rsqrt((v * v).mean(-1, keepdim=True) + self.a.eps) * self.w(name)

    def attention(self, i, h, tables):
        a, p = self.a, f"layers.{i}.mix."
        B, S, _ = h.shape
        G = a.heads // a.kv_heads
        q = self.mm(h, p + "w_q").view(B, S, a.heads, a.hd)
        k = self.mm(h, p + "w_k").view(B, S, a.kv_heads, a.hd)
        v = self.mm(h, p + "w_v").view(B, S, a.kv_heads, a.hd)
        if a.qk_norm:
            q, k = self._head_norm(q, p + "q_norm"), self._head_norm(k, p + "k_norm")
        q, k = rope(q, tables), rope(k, tables)
        if self.fp8:
            q, k, v = (fp8_round(t, True) for t in (q, k, v))
        o = CausalAttention.apply(q.reshape(B, S, a.kv_heads, G, a.hd).contiguous(),
                                  k.contiguous(), v.contiguous())
        return self.mm(o.reshape(B, S, a.heads * a.hd), p + "w_o")

    def swiglu(self, x, p):
        return self.mm(F.silu(self.mm(x, p + "w1")) * self.mm(x, p + "w3"), p + "w2")

    def dense_ffn(self, x, p):
        rows = x.reshape(-1, x.shape[-1])
        out = torch.cat([self.swiglu(rows[r:r + ROW_CHUNK], p)
                         for r in range(0, rows.shape[0], ROW_CHUNK)])
        return out.view(x.shape)

    def route(self, logits):
        """(probs, gates, picks, keep) of the repo's capacity routing of
        ``logits`` (N, E) float32."""
        a = self.a
        N, E = logits.shape
        probs = torch.softmax(logits, dim=-1)
        gates, picks = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, picks = gates[:, :a.top_k], picks[:, :a.top_k]
        if a.norm_topk:
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        onehot = F.one_hot(picks.reshape(-1), E)  # (N K, E), (token, pick) order
        slot = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1).view(N, a.top_k)
        return probs, gates, picks, slot < a.capacity(N)

    def moe_ffn(self, x, p):
        """(out, aux loss) over all tokens of x (B, S, D)."""
        a = self.a
        rows = x.reshape(-1, x.shape[-1])
        logits = self.mm(rows, p + "router")
        probs, gates, picks, keep = self.route(logits)
        self.dropped.append(int((~keep).sum()))
        out = torch.zeros_like(rows)
        we = [self.w(p + name) for name in ("we1", "we3", "we2")]
        for e in range(a.experts):
            n, kk = torch.nonzero((picks == e) & keep, as_tuple=True)
            if n.numel() == 0:
                continue
            xe = rows[n]
            w1, w3, w2 = (t[e] for t in we)
            if self.fp8:
                xe = fp8_round(xe, True)
                w1, w3, w2 = (fp8_round(t, False) for t in (w1, w3, w2))
                h = F.silu(xe @ w1) * (xe @ w3)
                y = fp8_round(h, True) @ w2
            else:
                y = (F.silu(xe @ w1) * (xe @ w3)) @ w2
            out = out.index_add(0, n, y * gates[n, kk][:, None])
        if a.shared:
            out = out + self.swiglu(rows, p + "shared.")
        me = probs.mean(0)
        ce = (F.one_hot(picks, a.experts).sum(1) > 0).float().mean(0)
        return out.view(x.shape), a.experts * torch.sum(me * ce)

    def layer(self, i, x, tables):
        """Layer ``i`` over x (B, S, D): (x, the MoE aux loss or None)."""
        p = f"layers.{i}."
        x = x + self.attention(i, self.rms(x, p + "ln1.scale"), tables)
        h = self.rms(x, p + "ln2.scale")
        if self.a.is_moe(i):
            f, aux = self.moe_ffn(h, p + "ffn.")
            return x + f, aux
        return x + self.dense_ffn(h, p + "ffn."), None

    @property
    def head_name(self):
        return "embed" if self.a.tied else "lm_head"

    def head(self, x):
        w = self.w(self.head_name)
        return self._mm(self.rms(x, "final_norm.scale"), w.T if self.a.tied else w)

    @torch.no_grad()
    def logits_at(self, tokens, rows):
        """Logits (len(rows), V) at positions ``rows`` of one sequence
        ``tokens`` (S,)."""
        S = tokens.shape[0]
        tables = rope_tables(S, self.a.hd, self.a.rope_theta, tokens.device)
        x = self.embed(tokens[None])
        for i in range(self.a.layers):
            x, _ = self.layer(i, x, tables)
        return self.head(x[0, rows])

    def layer_names(self, i):
        return [n for n, _, _ in self.a.leaves() if n.startswith(f"layers.{i}.")]

    def gradients(self, tokens, labels, aux_weight: float, sink):
        """Loss of one batch (B, S) (mean cross-entropy + aux_weight * the
        MoE aux losses summed) and its gradient, layer by layer: the forward
        keeps each layer's input, the backward recomputes one layer at a
        time. ``sink(name, grad)`` takes each parameter's gradient (float32)
        once. Returns the loss."""
        a = self.a
        B, S = tokens.shape
        N = B * S
        tables = rope_tables(S, a.hd, a.rope_theta, tokens.device)
        xs, aux_total = [], 0.0
        with torch.no_grad():
            x = self.embed(tokens)
            for i in range(a.layers):
                xs.append(x)
                x, aux = self.layer(i, x, tables)
                if aux is not None:
                    aux_total += float(aux)
        xl = x.detach().requires_grad_(True)
        self.live = {n: self.W[n].to(torch.float32, copy=True).requires_grad_(True)
                     for n in ("final_norm.scale", self.head_name)}
        flat, lab = xl.view(N, a.d), labels.reshape(N)
        ce_total = 0.0
        with torch.enable_grad():
            for r in range(0, N, ROW_CHUNK):
                lg = self.head(flat[r:r + ROW_CHUNK])
                ce = (torch.logsumexp(lg, -1)
                      - lg.gather(-1, lab[r:r + ROW_CHUNK, None])[:, 0]).sum() / N
                ce.backward()
                ce_total += float(ce.detach())
        sink("final_norm.scale", self.live["final_norm.scale"].grad)
        head_grad = self.live[self.head_name].grad
        if not a.tied:
            sink("lm_head", head_grad)
        dx = xl.grad
        for i in reversed(range(a.layers)):
            self.live = {n: self.W[n].to(torch.float32, copy=True).requires_grad_(True) for n in self.layer_names(i)}
            xi = xs[i].requires_grad_(True)
            with torch.enable_grad():
                xo, aux = self.layer(i, xi, tables)
                outs, grads = [xo], [dx]
                if aux is not None and aux_weight:
                    outs.append(aux * aux_weight)
                    grads.append(torch.ones_like(aux))
                torch.autograd.backward(outs, grads)
            for n, t in self.live.items():
                sink(n, t.grad)
            dx, xs[i] = xi.grad, None
        self.live = {}
        ge = (head_grad if a.tied
              else torch.zeros((a.vocab, a.d), dtype=torch.float32, device=tokens.device))
        ge.index_add_(0, tokens.reshape(N), dx.reshape(N, a.d) * a.embed_scale)
        sink("embed", ge)
        return ce_total + aux_weight * aux_total


def lr_at(step: int, hp: dict) -> float:
    """The cosine schedule with linear warm-up at ``step`` (1-based)."""
    base, warm, total = hp["lr"], hp["warmup"], hp["total_steps"]
    if step < warm:
        return base * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return 0.5 * base * (1.0 + math.cos(math.pi * prog))


def train(arch, W: dict, batches, hp: dict, aux_weight: float, fp8: bool = False,
          keep_grads: bool | None = None) -> dict:
    """``len(batches)`` AdamW steps (global-norm clip, bias-corrected moments,
    decoupled weight decay, float32 moments) on ``W`` (name -> bfloat16
    tensor, updated in place). Returns per step the loss and the global
    gradient norm before the clip, the first step's per-leaf norms of the
    clipped gradient and the picks past capacity in each MoE layer of its
    forward (``dropped``). ``keep_grads`` False recomputes the gradient for
    the update instead of holding it (for models whose float32 gradient does
    not fit beside the moments); None decides by the card's free memory."""
    ad = hp["adamw"]
    b1, b2, eps, wd, clip = ad["b1"], ad["b2"], ad["eps"], ad["weight_decay"], ad["clip_norm"]
    model = Model(arch, W, fp8=fp8)
    dev = next(iter(W.values())).device
    m = {n: torch.zeros(t.shape, dtype=torch.float32, device=dev) for n, t in W.items()}
    v = {n: torch.zeros(t.shape, dtype=torch.float32, device=dev) for n, t in W.items()}
    if keep_grads is None:
        need = 4 * sum(t.numel() for t in W.values())
        keep_grads = dev.type != "cuda" or need < 0.6 * torch.cuda.mem_get_info(dev)[0]
    out = {"loss": [], "grad_norm": [], "grad_leaf": {}}

    def update(step, scale, lr):
        bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step

        def one(name, g):
            g = g * scale
            m[name].mul_(b1).add_((1 - b1) * g)
            v[name].mul_(b2).add_((1 - b2) * g * g)
            p = W[name].float()
            u = (m[name] / bc1) / (torch.sqrt(v[name] / bc2) + eps) + wd * p
            W[name].copy_((p - lr * u).to(W[name].dtype))
        return one

    for step, (tokens, labels) in enumerate(batches, start=1):
        held, sumsq = {}, []

        def first(name, g):
            sumsq.append(torch.sum(g * g))
            if step == 1:
                out["grad_leaf"][name] = g.norm()
            if keep_grads:
                held[name] = g

        loss = model.gradients(tokens, labels, aux_weight, first)
        gn = float(torch.sqrt(torch.stack(sumsq).sum()))
        scale = min(1.0, clip / max(gn, 1e-9))
        one = update(step, scale, lr_at(step, hp))
        if keep_grads:
            for name, g in held.items():
                one(name, g)
            held.clear()
        else:
            model.gradients(tokens, labels, aux_weight, one)
        if step == 1:
            out["grad_leaf"] = {n: float(g) * scale for n, g in out["grad_leaf"].items()}
        out["loss"].append(loss)
        out["grad_norm"].append(gn)
        if step == 1:
            out["dropped"] = model.dropped[:arch.layers]  # the first forward's
    return out
