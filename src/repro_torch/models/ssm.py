"""Mamba-2 (SSD, state-space duality) blocks in PyTorch, chunked matmul form.

Counterpart of `repro.models.ssm`. The sequence is split into chunks of
`chunk` tokens; within a chunk the recurrence is a small causal
"attention dual" (a [q, q] decay-weighted product), across chunks a
[B, H, N, P] float32 state carries the rest. Decode is the O(1)-a-token
recurrent step. `repro` computes SSD with `jnp.einsum` under `lax.scan`,
outside any Pallas kernel, so here it is plain PyTorch too.

`ssd_chunked` computes every state-independent term of every chunk at once
(the intra-chunk product, the decays, each chunk's own state increment),
and only the [B, H, N, P] state runs chunk by chunk: two element-wise
operations a chunk where a loop of whole chunk steps would launch twenty.
The per-element arithmetic and its roundings are `repro`'s chunk step's.

Rounding follows `repro` as `jax.jit` compiles it. Group -> head
broadcasts are `repeat_interleave` (`jnp.repeat`). Where JAX promotes a
bf16 operand against a float32 one the port casts explicitly: the scores
times the float32 decays are float32, rounded to the input dtype before the
product with x·dt; the carried-state term is a float32 product of the
input-dtype C·exp(cum) with the float32 state, rounded to y's dtype; a
chunk's state increment is a product in the input dtype, added to the
float32 decayed state. Two bf16 roundings that `repro` writes XLA leaves
out, and the port with it: the conv's last addition before the float32
bias, and the gating product before its norm. softplus is
`jnp.logaddexp(x, 0)`'s formula. What stays apart is the order of sums:
XLA sums `jnp.cumsum` left to right in float32 and a norm's mean in
windows of 32, while `torch.cumsum` on the CPU accumulates in float64 and
`torch.mean` vectorizes; so the decays exp(cum_i - cum_j) and the norms
differ from `repro`'s by float32 ulps, and a bf16 value that lands near a
rounding boundary may round the other way.

Parameters: {"embed": [V, d] bf16, "final_norm": [d], "layers": [one dict
a layer]}; a layer {"ln", "in_proj", "conv_w", "conv_b", "dt_bias",
"A_log", "D", "gate_norm", "out_proj"}, the norms, biases, A_log and D
float32. Decode cache: {"ssm": float32 [L, B, H, N, P], "conv": bf16
[L, B, W-1, C]}, updated in place by `decode_step`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.decoder import TensorSpec, allocate


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    d_state: int  # N
    vocab: int
    head_dim: int = 64  # P
    expand: int = 2
    n_groups: int = 1  # G (B/C groups)
    conv_width: int = 4
    chunk: int = 128
    norm_eps: float = 1e-6
    tie_embed: bool = True
    remat: str = "full"  # "none" | "dots" | "full" (common.remat), each layer
    sub_quadratic: bool = True

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of head_dim "
                             f"{self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    def param_count(self) -> int:
        d, di, g, n, h = (self.d_model, self.d_inner, self.n_groups, self.d_state,
                          self.n_heads)
        per_layer = (
            d * (2 * di + 2 * g * n + h)  # in_proj
            + self.conv_width * self.conv_channels
            + self.conv_channels
            + 3 * h  # dt_bias, A_log, D
            + di  # gate norm
            + di * d  # out_proj
            + d  # ln
        )
        return int(self.n_layers * per_layer + self.vocab * d + d)

    def active_param_count(self) -> int:
        return self.param_count()


# ------------------------------------------------------------------ params
def init_mamba_layer(generator: torch.Generator, cfg: Mamba2Config) -> Dict[str, torch.Tensor]:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    gn = cfg.n_groups * cfg.d_state
    dev = generator.device

    def full(n, value):
        return torch.full((n,), value, dtype=torch.float32, device=dev)

    return {
        "ln": full(d, 0.0),
        "in_proj": cm.ninit(generator, (d, 2 * di + 2 * gn + h), d),
        "conv_w": cm.ninit(generator, (cfg.conv_width, cfg.conv_channels), cfg.conv_width),
        "conv_b": full(cfg.conv_channels, 0.0),
        "dt_bias": full(h, 0.0),
        "A_log": full(h, 0.0),
        "D": full(h, 1.0),
        "gate_norm": full(di, 0.0),
        "out_proj": cm.ninit(generator, (di, d), di),
    }


def init_params(generator: torch.Generator, cfg: Mamba2Config) -> Dict[str, Any]:
    """Random parameters from `generator`, on its device (the port's own
    draws: a test that compares with `repro` converts `repro`'s)."""
    layers = [init_mamba_layer(generator, cfg) for _ in range(cfg.n_layers)]
    return {
        "embed": cm.ninit(generator, (cfg.vocab, cfg.d_model), cfg.d_model),
        "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                  device=generator.device),
        "layers": layers,
    }


def mamba_layer_logical(cfg: Mamba2Config) -> Dict[str, Tuple[str, ...]]:
    """Logical axes of one Mamba layer's parameters, as in `repro`."""
    return {
        "ln": ("embed",),
        "in_proj": ("embed", "ssm_heads"),
        "conv_w": ("conv", "ssm_heads"),
        "conv_b": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "gate_norm": ("ssm_heads",),
        "out_proj": ("ssm_heads", "embed"),
    }


def param_logical(cfg: Mamba2Config) -> Dict[str, Any]:
    """Logical axes of `init_params`' tree: `repro`'s, each layer's without
    the stack's "layers" axis."""
    return {"embed": ("vocab", "embed"), "final_norm": ("embed",),
            "layers": [mamba_layer_logical(cfg) for _ in range(cfg.n_layers)]}


# ----------------------------------------------------------------- core SSD
def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`, which is `jnp.logaddexp(x, 0)`:
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over the sequence. x [B, S, C], w [W, C]. With
    `state` ([B, W-1, C]) it runs in streaming mode. Returns (silu(conv) in
    x's dtype, the last W-1 rows of the padded input: the new state). The W
    products and the running sum are rounded to x's dtype, as `repro`'s
    Python sum is, but for the last addition: XLA keeps its float32 result
    unrounded into the float32 bias add, and so does the port."""
    width, s = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+W-1, C]
    terms = [xp[:, i:i + s, :] * w[i][None, None, :] for i in range(width)]
    out = sum(terms[:-1])
    out = out.to(torch.float32) + terms[-1].to(torch.float32) + b[None, None, :]
    new_state = xp[:, xp.shape[1] - (width - 1):, :]
    return F.silu(out.to(torch.float32)).to(x.dtype), new_state


def _split_proj(h: torch.Tensor, cfg: Mamba2Config):
    di, gn, nh = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.n_heads
    z = h[..., :di]
    xbc = h[..., di:di + di + 2 * gn]
    dt = h[..., di + di + 2 * gn:]
    if dt.shape[-1] != nh:
        raise ValueError(f"in_proj width leaves {dt.shape[-1]} dt columns, want {nh}")
    return z, xbc, dt


def ssd_chunked(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] float32, after softplus
    A: torch.Tensor,  # [H] float32, negative
    B_in: torch.Tensor,  # [B, S, G, N]
    C_in: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B, H, N, P] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, S, H, P] in x's dtype, final state [B, H, N, P]
    float32). The chunk is min(chunk, S), and it must divide S, as in
    `repro`: no prompt is padded."""
    b, s, h, p = x.shape
    g, n = B_in.shape[2], B_in.shape[3]
    hg = h // g
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk {q}")
    nc = s // q
    dtype = x.dtype

    xr = x.reshape(b, nc, q, h, p)
    dtr = dt.reshape(b, nc, q, h)
    Br = B_in.reshape(b, nc, q, g, n)
    Cr = C_in.reshape(b, nc, q, g, n)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))

    a = dtr * A  # [b, c, q, h] log-decays (<= 0)
    cum = torch.cumsum(a, dim=2)  # inclusive
    total = cum[:, :, -1, :]  # [b, c, h]
    # intra-chunk (quadratic in q: the "attention dual"), every chunk at once,
    # the heads ahead of the [q, q] plane so that its passes run contiguous
    cum_h = cum.transpose(2, 3).contiguous()  # [b, c, h, q]
    # masked before the exp, where repro masks after it: above the diagonal
    # cum_i - cum_j is a positive sum of dt that overflows exp at a full
    # chunk, and the masked inf then makes the gradient 0 * inf = NaN (as
    # repro's is). The values are the same: exp(-inf) is 0.
    L = torch.exp(torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :],
                              float("-inf")))  # [b, c, h, qi, qj]
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cr, Br)  # [b, c, g, qi, qj]
    # groups -> heads as jnp.repeat maps them: head j reads group j // hg
    w = (scores[:, :, :, None] * L.view(b, nc, g, hg, q, q)).to(dtype).view(b, nc, h, q, q)
    xdt = xr * dtr[..., None].to(dtype)
    y = torch.einsum("bchqk,bckhp->bcqhp", w, xdt)
    # each chunk's own state increment, independent of the carried state
    decay_to_end = torch.exp(total[:, :, None, :] - cum)  # [b, c, q, h]
    Bh = Br.repeat_interleave(hg, dim=3)  # [b, c, q, h, n]
    inc = torch.einsum("bcqhn,bcqhp->bchnp",
                       (Bh * (decay_to_end * dtr)[..., None]).to(dtype), xr)
    # the carried state, chunk by chunk: the state entering chunk c
    state = (init_state if init_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device))
    decay = torch.exp(total)[..., None, None]  # [b, c, h, 1, 1]
    entering = []
    for c in range(nc):
        entering.append(state)
        state = (decay[:, c] * state + inc[:, c]).to(torch.float32)
    entering = torch.stack(entering, dim=1)  # [b, c, h, n, p]
    # inter-chunk: the contribution of the carried state, float32 as JAX
    # promotes the input-dtype operand against the float32 state
    Ch = Cr.repeat_interleave(hg, dim=3)  # [b, c, q, h, n]
    carried = (Ch * torch.exp(cum)[..., None]).to(dtype).to(torch.float32)
    y = y + torch.einsum("bcqhn,bchnp->bcqhp", carried, entering).to(y.dtype)
    return y.reshape(b, s, h, p), state


def _ssd_sharded(x, dt, A, B_in, C_in, chunk: int) -> torch.Tensor:
    """`ssd_chunked`'s y for DTensors, on local tensors (DTensor's layouts
    for the chunk products' gradients are strided ones it cannot always
    propagate): each rank runs the SSD of its rows of the batch (over the
    data axes, where they divide) and of its heads (over "model", where the
    heads and groups divide; else every head), the groups' B and C whole
    where one group serves heads of several ranks. Returns y laid out as
    the rank's x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    n_dp, n_h = 1, 1
    for i in range(len(names)):
        if i in dp:
            n_dp *= mesh.size(i)
        else:
            n_h *= mesh.size(i)
    b, _, h, _ = x.shape
    g = B_in.shape[2]
    rows = Shard(0) if b % n_dp == 0 else Replicate()
    split = h % n_h == 0
    split_groups = split and g % n_h == 0
    lay = lambda on_h: tuple(rows if i in dp else on_h for i in range(len(names)))  # noqa: E731
    x_lay = lay(Shard(2) if split else Replicate())
    bc_lay = lay(Shard(2) if split_groups else Replicate())
    bc_grad = lay(Shard(2) if split_groups else (Partial() if split else Replicate()))
    a_lay = tuple(Replicate() if i in dp else (Shard(0) if split else Replicate())
                  for i in range(len(names)))
    a_grad = tuple((Partial() if rows == Shard(0) else Replicate()) if i in dp else pl
                   for i, pl in enumerate(a_lay))
    y, _ = ssd_chunked(x.redistribute(mesh, x_lay).to_local(),
                       dt.redistribute(mesh, x_lay).to_local(),
                       A.redistribute(mesh, a_lay).to_local(grad_placements=a_grad),
                       B_in.redistribute(mesh, bc_lay).to_local(grad_placements=bc_grad),
                       C_in.redistribute(mesh, bc_lay).to_local(grad_placements=bc_grad),
                       chunk)
    return DTensor.from_local(y, mesh, x_lay, run_check=False)


def _gate(y: torch.Tensor, z: torch.Tensor, p, cfg: Mamba2Config) -> torch.Tensor:
    """rms_norm(y * silu(z)) in y's dtype. silu(z) is rounded to z's dtype;
    the product is a bf16 product in `repro`, which XLA leaves unrounded
    into the norm's float32 arithmetic, and so does the port."""
    g = y.to(torch.float32) * F.silu(z.to(torch.float32)).to(z.dtype).to(torch.float32)
    return cm.rms_norm(g, p["gate_norm"], cfg.norm_eps).to(y.dtype)


def mamba_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: Mamba2Config) -> torch.Tensor:
    """Full Mamba-2 block with pre-norm and residual. x [B, S, d]."""
    b, s, _ = x.shape
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    proj = cm.pin_grad(h @ p["in_proj"])
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    xs = cm.reshape(xbc[..., :di], b, s, cfg.n_heads, cfg.head_dim)
    B_in = cm.reshape(xbc[..., di:di + gn], b, s, cfg.n_groups, cfg.d_state)
    C_in = cm.reshape(xbc[..., di + gn:], b, s, cfg.n_groups, cfg.d_state)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if cm.is_dtensor(xs):
        y = _ssd_sharded(cm.pin_grad(xs), dt, A, B_in, C_in, cfg.chunk)
    else:
        y, _ = ssd_chunked(xs, dt, A, B_in, C_in, cfg.chunk)
    y = cm.pin_grad(y) + cm.pin_grad(xs) * p["D"][None, None, :, None].to(xs.dtype)
    y = cm.pin_grad(_gate(cm.reshape(y, b, s, di), z, p, cfg))
    return x + cm.pinned_tokens(y @ p["out_proj"]).to(x.dtype)


def _ssd_step(xs, dt1, A, B_in, C_in, ssm_state, hg: int):
    """The recurrence of one token: (y [B, H, P] float32, the new state
    [B, H, N, P])."""
    Bh = B_in.repeat_interleave(hg, dim=1)  # [B, H, N]
    Ch = C_in.repeat_interleave(hg, dim=1)
    decay = torch.exp(dt1 * A[None, :])  # [B, H]
    upd = ((dt1[..., None] * Bh.to(torch.float32))[..., :, None]
           * xs.to(torch.float32)[..., None, :])
    ssm_state = decay[..., None, None] * ssm_state + upd  # [B, H, N, P]
    return torch.einsum("bhn,bhnp->bhp", Ch.to(torch.float32), ssm_state), ssm_state


def _ssd_step_sharded(xs, dt1, A, B_in, C_in, ssm_state, hg: int):
    """`_ssd_step` against a DTensor state, on local tensors: each rank steps
    its rows of the batch and its heads, as the cache lays the state out
    (DTensor's layout for the state products is a strided one it cannot
    propagate). Returns y laid out as the state's rows and heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = ssm_state.device_mesh
    lay = tuple(pl if pl in (Shard(0), Shard(1)) else Replicate() for pl in ssm_state.placements)
    state = ssm_state.redistribute(mesh, lay).to_local()
    rows = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in lay)
    heads = tuple(Shard(0) if pl == Shard(1) else Replicate() for pl in lay)
    coord, first = mesh.get_coordinate(), 0
    for i, pl in enumerate(lay):
        if pl == Shard(1):
            first = first * mesh.size(i) + coord[i]
    h_loc = state.shape[1]
    first *= h_loc

    def group_rows(t):  # [B, G, N] -> this rank's heads' rows [B_l, H_l, N]
        t = t.redistribute(mesh, rows).to_local().repeat_interleave(hg, dim=1)
        return t[:, first:first + h_loc]

    y, state = _ssd_step(xs.redistribute(mesh, lay).to_local(),
                         dt1.redistribute(mesh, lay).to_local(),
                         A.redistribute(mesh, heads).to_local(),
                         group_rows(B_in), group_rows(C_in), state, 1)
    return (DTensor.from_local(y, mesh, lay, run_check=False),
            DTensor.from_local(state, mesh, lay, run_check=False))


def mamba_decode_block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: Mamba2Config,
                       ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """Single-token recurrent step. x [B, 1, d]. Returns (x, ssm', conv')."""
    b = x.shape[0]
    h = cm.rms_norm(x, p["ln"], cfg.norm_eps)
    proj = h @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"], state=conv_state)
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    xs = xbc[:, 0, :di].reshape(b, cfg.n_heads, cfg.head_dim)
    B_in = xbc[:, 0, di:di + gn].reshape(b, cfg.n_groups, cfg.d_state)
    C_in = xbc[:, 0, di + gn:].reshape(b, cfg.n_groups, cfg.d_state)
    dt1 = softplus(dt[:, 0].to(torch.float32) + p["dt_bias"])  # [B, H]
    A = -torch.exp(p["A_log"])
    step = _ssd_step_sharded if cm.is_dtensor(ssm_state) else _ssd_step
    y, ssm_state = step(xs, dt1, A, B_in, C_in, ssm_state, cfg.n_heads // cfg.n_groups)
    y = y.to(xs.dtype) + xs * p["D"][None, :, None].to(xs.dtype)
    y = _gate(y.reshape(b, 1, di), z, p, cfg)
    return x + (y @ p["out_proj"]).to(x.dtype), ssm_state, conv_state


# ------------------------------------------------------------- full LM defs
def forward(params, tokens: torch.Tensor, cfg: Mamba2Config):
    """Training and prefill trunk. tokens [B, S] -> (final features
    [B, S, d], 0). Under autograd each layer runs under `cfg.remat`."""
    x = cm.embed(tokens, params["embed"])
    block = cm.remat(mamba_block, cfg.remat)
    for lp in params["layers"]:
        x = cm.token_layout(block(x, lp, cfg))
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params, batch, cfg: Mamba2Config) -> torch.Tensor:
    """Mean next-token cross entropy of batch["labels"] (chunked), through
    the SSD chunked form: its backward is autograd's."""
    feats, aux = forward(params, batch["tokens"], cfg)
    return cm.cross_entropy_chunked(feats, params["embed"], batch["labels"]) + aux


@torch.no_grad()
def prefill_logits(params, batch, cfg: Mamba2Config) -> torch.Tensor:
    """Next-token logits [B, 1, V] float32 of a prompt batch."""
    feats, _ = forward(params, batch["tokens"], cfg)
    return cm.last_token_logits(feats, params["embed"])


def init_cache_shape(cfg: Mamba2Config, batch: int, cache_len: int) -> Dict[str, TensorSpec]:
    del cache_len  # the state is O(1) in the context length
    return {
        "ssm": TensorSpec((cfg.n_layers, batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                          torch.float32),
        "conv": TensorSpec((cfg.n_layers, batch, cfg.conv_width - 1, cfg.conv_channels),
                           cm.DEFAULT_DTYPE),
    }


def init_cache(cfg: Mamba2Config, batch: int, cache_len: int, device) -> Dict[str, torch.Tensor]:
    return allocate(init_cache_shape(cfg, batch, cache_len), device)


def cache_logical(cfg: Mamba2Config) -> Dict[str, Tuple[Optional[str], ...]]:
    return {
        "ssm": ("layers", "batch", "ssm_heads", "ssm_state", "head_dim"),
        "conv": ("layers", "batch", "conv", "ssm_heads"),
    }


@torch.no_grad()
def decode_step(params, cache, tokens: torch.Tensor, pos, cfg: Mamba2Config):
    """One-token decode; `pos` is unused (the state has no positions).
    Returns (logits [B, 1, V] float32, cache), the cache updated in place."""
    del pos
    x = cm.embed(tokens, params["embed"])
    for i, lp in enumerate(params["layers"]):
        x, ssm, conv = mamba_decode_block(x, lp, cfg, cache["ssm"][i], cache["conv"][i])
        x = cm.token_layout(x)
        cache["ssm"][i].copy_(ssm)
        cache["conv"][i].copy_(conv)
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return cm.unembed(x, params["embed"]), cache
