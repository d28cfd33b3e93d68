"""Sequence-state models: xLSTM (mLSTM + sLSTM) and Mamba, plus the FFT
long-convolution mixer that runs the paper's FFT inside an LM (the port's
counterpart of the JAX package's ``models/ssm.py``).

As in the reference, nothing materializes a (B, S, d_inner, d_state)
tensor: Mamba runs a chunked selective scan (a float32 recurrence inside
each chunk, the state carried between chunks), and mLSTM's chunkwise-
parallel form carries its matrix memory across chunks while decode is the
O(d^2) recurrence.

Decode state trees (the SSM "KV cache"), ``pos`` a Python int:
  mlstm: {"C": (B,H,dk,dv), "n": (B,H,dk), "m": (B,H), "pos"}
  slstm: {"c","n","h": (B,D), "m": (B,D), "pos"}
  mamba: {"conv": (B, d_conv-1, d_inner), "h": (B, d_inner, N), "pos"}

:func:`fft_conv` transforms through the port's ``core.transforms.apply_1d``:
``fft_backend="cufft"`` (the default, the reference's ``"xla"``) is
torch.fft, and ``"kernel"`` runs the hand-written four-step kernel, three
launches per call on contiguous lines of length 2S.

On a mesh, Mamba and ``fft_conv`` are channel-parallel: each rank holds
``d_inner / |model|`` channels (``w_in``'s x and z column blocks, taken
from its gathered whole because the reference's split of ``2 * d_inner``
columns does not follow the channels; ``conv_w``, ``basis_w`` and the rest
by spec), Mamba sums its ``w_x`` projection over "model", and ``w_out`` is
row-parallel (``sharding.tp_sum``).  ``fft_conv``'s kernel then transforms
this rank's ``(B * d_inner / |model|, 2S)`` lines.  mLSTM and sLSTM
compute replicated on every rank of "model" with their parameters gathered
whole for the layer (``sharding.use(..., tp="slice")``): their heads are
not split (a deviation from the reference's layout, not its specs).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import MeshRules, shard, tp_copy, tp_sum, use
from .config import ModelConfig
from .layers import as_param


def _out_scale(cfg: ModelConfig) -> float:
    return 0.02 / math.sqrt(2 * cfg.n_layers)


def _channel_in(x: torch.Tensor, w_in: torch.Tensor, di: int,
                rules: Optional[MeshRules]):
    """``(x, z)`` of this rank's channels: ``x @ w_in`` on its columns
    ``[c0, c0 + n)`` and ``[di + c0, di + c0 + n)`` of the whole ``w_in``
    (the input's gradient is partial over "model")."""
    tp = rules.tp_size if rules is not None else 1
    w = use(w_in, rules, tp="sum").to(x.dtype)
    if tp > 1:
        n = di // tp
        c0 = rules.tp_index * n
        w = torch.cat([w[:, c0:c0 + n], w[:, di + c0:di + c0 + n]], dim=1)
    return torch.chunk(tp_copy(x, rules) @ w, 2, dim=-1)


# ---------------------------------------------------------------------------
# mLSTM (matrix-memory, exponential gating) — xLSTM's parallel workhorse
# ---------------------------------------------------------------------------

def _mlstm_chunked(q, k, v, i_pre, logf, *, chunk: int):
    """Chunkwise-parallel stabilized mLSTM.

    Within a chunk of length L the decay matrix is (L, L); across chunks the
    matrix memory (C, n, m) is carried recurrently.  q,k,v: (B, S, H, d);
    i_pre/logf: (B, S, H).  Returns (out, (C, n, m)).
    """
    b_, s, h, dh = q.shape
    if s % chunk:
        raise AssertionError("sequence must divide the mLSTM chunk")
    nc = s // chunk
    qf = q.float().reshape(b_, nc, chunk, h, dh)
    kf = k.float().reshape(b_, nc, chunk, h, dh)
    vf = v.float().reshape(b_, nc, chunk, h, dh)
    ic = i_pre.reshape(b_, nc, chunk, h)
    fc = logf.reshape(b_, nc, chunk, h)
    dev = q.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))

    c_st = torch.zeros((b_, h, dh, dh), dtype=torch.float32, device=dev)
    n_st = torch.zeros((b_, h, dh), dtype=torch.float32, device=dev)
    m_st = torch.full((b_, h), -1e30, dtype=torch.float32, device=dev)
    outs = []
    for ci in range(nc):
        qc, kc, vc = qf[:, ci], kf[:, ci], vf[:, ci]
        ii, ff = ic[:, ci], fc[:, ci]
        cum = torch.cumsum(ff, dim=1)       # (B, L, H) in-chunk sum of logf
        # intra-chunk decay D[t,u] = F_t - F_u + i_u (u <= t)
        dmat = cum[:, :, None, :] - cum[:, None, :, :] + ii[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -math.inf)
        m_intra = dmat.amax(dim=2)          # (B, L, H)
        # inter-chunk: state contribution decays by F_t from chunk start
        m_state = cum + m_st[:, None, :]
        m_tot = torch.maximum(m_intra, m_state)

        dsc = torch.exp(dmat - m_tot[:, :, None, :])
        scores = torch.einsum("blhd,buhd->bluh", qc, kc) * dsc
        num_intra = torch.einsum("bluh,buhd->blhd", scores, vc)
        den_intra = scores.sum(dim=2)

        w_state = torch.exp(m_state - m_tot)
        num_state = torch.einsum("blhk,bhkv->blhv", qc, c_st) \
            * w_state[..., None]
        den_state = torch.einsum("blhk,bhk->blh", qc, n_st) * w_state

        den = torch.maximum(torch.abs(den_intra + den_state),
                            torch.exp(-m_tot))
        outs.append((num_intra + num_state) / den[..., None])

        # fold this chunk into the carried state
        f_all = cum[:, -1]                  # (B, H) total chunk decay
        m_new = torch.maximum(f_all + m_st,
                              (f_all[:, None] - cum + ii).amax(dim=1))
        w_c = torch.exp(f_all[:, None] - cum + ii - m_new[:, None])
        decay = torch.exp(f_all + m_st - m_new)
        c_st = decay[..., None, None] * c_st \
            + torch.einsum("buh,buhk,buhv->bhkv", w_c, kc, vc)
        n_st = decay[..., None] * n_st \
            + torch.einsum("buh,buhk->bhk", w_c, kc)
        m_st = m_new
    out = torch.stack(outs, dim=1).reshape(b_, s, h, dh)
    return out, (c_st, n_st, m_st)


class MLSTM(nn.Module):
    def __init__(self, b, path: str, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di = cfg.expand * d
        h = cfg.n_heads
        self.w_in = as_param(b.param(f"{path}/w_in", (d, 2 * di),
                                     ("fsdp", "tp")))
        self.wq = as_param(b.param(f"{path}/wq", (di, di), ("fsdp", "tp")))
        self.wk = as_param(b.param(f"{path}/wk", (di, di), ("fsdp", "tp")))
        self.wv = as_param(b.param(f"{path}/wv", (di, di), ("fsdp", "tp")))
        self.w_if = as_param(b.param(f"{path}/w_if", (di, 2 * h),
                                     ("fsdp", None)))
        self.w_out = as_param(b.param(f"{path}/w_out", (di, d),
                                      ("tp", "fsdp"), scale=_out_scale(cfg)))
        self.skip_scale = as_param(b.param(f"{path}/skip_scale", (di,),
                                           (None,), init="ones"))

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Dict] = None,
                rules: Optional[MeshRules] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        b_, s, d = x.shape
        dt = x.dtype
        di = cfg.expand * d
        h = cfg.n_heads
        dh = di // h

        def w(p):   # replicated over "model": the whole leaf
            return use(p, rules, tp="slice").to(dt)

        xz = shard(x @ w(self.w_in), rules, "batch", None, "tp")
        xi, z = torch.chunk(xz, 2, dim=-1)
        q = (xi @ w(self.wq)).reshape(b_, s, h, dh)
        k = (xi @ w(self.wk)).reshape(b_, s, h, dh) / math.sqrt(dh)
        v = (xi @ w(self.wv)).reshape(b_, s, h, dh)
        gates = (xi @ w(self.w_if)).float()
        i_pre, f_pre = gates.reshape(b_, s, 2, h).unbind(dim=2)  # (B, S, H)
        logf = F.logsigmoid(f_pre)

        new_cache = None
        if mode in ("train", "prefill"):
            out, st = _mlstm_chunked(q, k, v, i_pre, logf,
                                     chunk=min(256, s))
            if mode == "prefill":
                new_cache = {"C": st[0], "n": st[1], "m": st[2], "pos": s}
        elif mode == "decode":
            if cache is None or s != 1:
                raise ValueError("mLSTM decode takes one token and a cache")
            c_prev, n_prev, m_prev = cache["C"], cache["n"], cache["m"]
            lf = logf[:, 0]                                    # (B, H)
            ii = i_pre[:, 0]
            m_new = torch.maximum(lf + m_prev, ii)
            fg = torch.exp(lf + m_prev - m_new)[..., None, None]
            ig = torch.exp(ii - m_new)[..., None, None]
            k1 = k[:, 0][..., :, None].float()                 # (B,H,dk,1)
            v1 = v[:, 0][..., None, :].float()                 # (B,H,1,dv)
            c_new = fg * c_prev + ig * (k1 * v1)               # (B,H,dk,dv)
            n_new = fg[..., 0] * n_prev + ig[..., 0] * k1[..., 0]
            q1 = q[:, 0].float()                               # (B,H,dk)
            num = torch.einsum("bhkv,bhk->bhv", c_new, q1)
            den = torch.maximum(
                torch.abs(torch.einsum("bhk,bhk->bh", n_new, q1)),
                torch.exp(-m_new))
            out = (num / den[..., None])[:, None].reshape(b_, 1, h, dh)
            new_cache = {"C": c_new, "n": n_new, "m": m_new,
                         "pos": cache["pos"] + 1}
        else:
            raise ValueError(mode)

        out = out.reshape(b_, s, di).to(dt)
        out = out + xi * self.skip_scale.to(dt)
        out = out * F.silu(z)
        y = out @ w(self.w_out)
        return shard(y, rules, "batch", None, None), new_cache


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, block-diagonal recurrence)
# ---------------------------------------------------------------------------

class SLSTM(nn.Module):
    def __init__(self, b, path: str, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        h = cfg.n_heads
        dh = d // h
        self.w_gates = as_param(b.param(f"{path}/w_gates", (d, 4 * d),
                                        ("fsdp", "tp")))
        self.r_gates = as_param(b.param(f"{path}/r_gates", (h, dh, 4 * dh),
                                        (None, None, None), scale=0.02))
        self.w_out = as_param(b.param(f"{path}/w_out", (d, d),
                                      ("tp", "fsdp"), scale=_out_scale(cfg)))

    def step(self, x_t: torch.Tensor, state: Dict):
        """One sLSTM step.  x_t: (B, 4D) pre-projected gates."""
        b_, four_d = x_t.shape
        d = four_d // 4
        h = self.cfg.n_heads
        dh = d // h
        hx = state["h"].reshape(b_, h, dh)
        rec = torch.einsum("bhd,hdk->bhk", hx.float(),
                           self.r_gates.float()).reshape(b_, 4 * d)
        pre = x_t.float() + rec
        z_pre, i_pre, f_pre, o_pre = torch.chunk(pre, 4, dim=-1)
        zt = torch.tanh(z_pre)
        ot = torch.sigmoid(o_pre)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + state["m"], i_pre)
        ig = torch.exp(i_pre - m_new)
        fg = torch.exp(logf + state["m"] - m_new)
        c_new = fg * state["c"] + ig * zt
        n_new = fg * state["n"] + ig
        h_new = ot * (c_new / torch.clamp(n_new, min=1e-6))
        return h_new, {"c": c_new, "n": n_new, "m": m_new, "h": h_new}

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Dict] = None,
                rules: Optional[MeshRules] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        b_, s, d = x.shape
        dt = x.dtype
        # replicated over "model": the whole leaves
        w_out = use(self.w_out, rules, tp="slice").to(dt)
        gates_in = x @ use(self.w_gates, rules, tp="slice").to(dt)
        if cache is not None:
            state = cache
        else:
            z = torch.zeros((b_, d), dtype=torch.float32, device=x.device)
            state = {"c": z, "n": z, "h": z, "pos": 0,
                     "m": torch.full((b_, d), -1e30, dtype=torch.float32,
                                     device=x.device)}
        carry = {k: v for k, v in state.items() if k != "pos"}

        if mode == "decode":
            h_new, st = self.step(gates_in[:, 0], carry)
            st["pos"] = state["pos"] + 1
            y = h_new[:, None].to(dt) @ w_out
            return shard(y, rules, "batch", None, None), st

        hs = []
        for t in range(s):
            h_new, carry = self.step(gates_in[:, t], carry)
            hs.append(h_new)
        hs = torch.stack(hs, dim=1).to(dt)                   # (B, S, D)
        y = hs @ w_out
        new_cache = None
        if mode == "prefill":
            carry["pos"] = state["pos"] + s
            new_cache = carry
        return shard(y, rules, "batch", None, None), new_cache


# ---------------------------------------------------------------------------
# Mamba (selective SSM) — chunked scan
# ---------------------------------------------------------------------------

class Mamba(nn.Module):
    def __init__(self, b, path: str, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di = cfg.expand * d
        n = cfg.d_state
        dt_rank = max(1, math.ceil(d / 16))
        self.w_in = as_param(b.param(f"{path}/w_in", (d, 2 * di),
                                     ("fsdp", "tp")))
        self.conv_w = as_param(b.param(f"{path}/conv_w", (cfg.d_conv, di),
                                       (None, "tp")))
        self.conv_b = as_param(b.param(f"{path}/conv_b", (di,), ("tp",),
                                       init="zeros"))
        self.w_x = as_param(b.param(f"{path}/w_x", (di, dt_rank + 2 * n),
                                    ("tp", None)))
        self.w_dt = as_param(b.param(f"{path}/w_dt", (dt_rank, di),
                                     (None, "tp")))
        self.dt_bias = as_param(b.param(f"{path}/dt_bias", (di,), ("tp",),
                                        init="ones"))
        self.a_log = as_param(b.param(f"{path}/a_log", (di, n), ("tp", None),
                                      init="mamba_a"))
        self.d_skip = as_param(b.param(f"{path}/d_skip", (di,), ("tp",),
                                       init="ones"))
        self.w_out = as_param(b.param(f"{path}/w_out", (di, d),
                                      ("tp", "fsdp"), scale=_out_scale(cfg)))

    def _inner(self, xc: torch.Tensor, rules: Optional[MeshRules] = None):
        """Selective-scan coefficients.  xc: (B, L, di) float32 (this
        rank's channels)."""
        n = self.cfg.d_state
        dt_rank = self.w_dt.shape[0]
        # (B, L, r+2N): summed over the channels of every rank, then read
        # by this rank's channels
        proj = tp_copy(tp_sum(xc @ self.w_x.to(xc.dtype), rules), rules)
        dt_raw, b_in, c_in = torch.split(proj, [dt_rank, n, n], dim=-1)
        delta = F.softplus(dt_raw @ self.w_dt.to(xc.dtype)
                           + self.dt_bias.to(xc.dtype))       # (B, L, di)
        a = -torch.exp(self.a_log.float())                   # (di, N)
        abar = torch.exp(delta[..., None] * a[None, None])   # (B, L, di, N)
        bx = (delta * xc)[..., None] * b_in[:, :, None, :]   # (B, L, di, N)
        return abar, bx, c_in

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Dict] = None, chunk: int = 128,
                rules: Optional[MeshRules] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        cfg = self.cfg
        b_, s, d = x.shape
        dt = x.dtype
        kw = cfg.d_conv

        xin, z = _channel_in(x, self.w_in, cfg.expand * d, rules)
        xin = shard(xin, rules, "batch", None, "tp")
        di = xin.shape[-1]   # this rank's channels

        # causal depthwise conv
        if mode == "decode" and cache is not None:
            conv_state_in = cache["conv"]
        else:
            conv_state_in = torch.zeros((b_, kw - 1, di), dtype=dt,
                                        device=x.device)
        if mode == "decode":
            xpad = torch.cat([conv_state_in.to(dt), xin], dim=1)
        else:
            xpad = F.pad(xin, (0, 0, kw - 1, 0))
        conv = sum(xpad[:, i:i + s] * self.conv_w[i].to(dt)
                   for i in range(kw)) + self.conv_b.to(dt)
        xc = F.silu(conv).float()

        if mode == "decode":
            if cache is None or s != 1:
                raise ValueError("Mamba decode takes one token and a cache")
            abar, bx, c_in = self._inner(xc, rules)
            h = abar[:, 0] * cache["h"] + bx[:, 0]           # (B, di, N)
            y = torch.einsum("bdn,bn->bd", h, c_in[:, 0])[:, None]
            new_conv = torch.cat([conv_state_in[:, 1:], xin], dim=1)
            new_cache = {"conv": new_conv.to(dt), "h": h,
                         "pos": cache["pos"] + 1}
        else:
            lc = min(chunk, s)
            if s % lc:
                raise AssertionError("sequence must divide the scan chunk")
            # the chunked scan's input is stored in the activations' dtype
            # (compute stays float32 inside each chunk), as the reference
            xcs = xc.reshape(b_, s // lc, lc, di).to(dt)
            h = torch.zeros((b_, di, cfg.d_state), dtype=torch.float32,
                            device=x.device)
            ys = []
            for ci in range(s // lc):
                abar, bx, c_in = self._inner(xcs[:, ci].float(), rules)
                for t in range(lc):   # h_t = abar_t h_{t-1} + bx_t
                    h = abar[:, t] * h + bx[:, t]
                    ys.append(torch.einsum("bdn,bn->bd", h, c_in[:, t]))
            y = torch.stack(ys, dim=1)                       # (B, S, di)
            new_cache = None
            if mode == "prefill":
                new_cache = {"conv": xin[:, s - (kw - 1):, :].to(dt),
                             "h": h, "pos": s}

        y = y + xc * self.d_skip.float()
        y = y.to(dt) * F.silu(z)
        out = tp_sum(y @ use(self.w_out, rules).to(dt), rules)
        return shard(out, rules, "batch", None, None), new_cache


# ---------------------------------------------------------------------------
# FFT long-convolution mixer (Hyena-style) — the paper's FFT inside an LM
# ---------------------------------------------------------------------------

class FFTConv(nn.Module):
    def __init__(self, b, path: str, cfg: ModelConfig, n_basis: int = 16):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        di = cfg.expand * d
        self.w_in = as_param(b.param(f"{path}/w_in", (d, 2 * di),
                                     ("fsdp", "tp")))
        self.basis_w = as_param(b.param(f"{path}/basis_w", (di, n_basis),
                                        ("tp", None)))
        self.decay = as_param(b.param(f"{path}/decay", (n_basis,), (None,),
                                      init="ones"))
        self.w_out = as_param(b.param(f"{path}/w_out", (di, d),
                                      ("tp", "fsdp"), scale=_out_scale(cfg)))

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Dict] = None, fft_backend: str = "cufft",
                rules: Optional[MeshRules] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """Causal implicit long convolution via FFT (no decode form).

        y[:, t] = sum_{u<=t} h[:, t-u] * x[:, u], h built from a decaying
        basis, through ``core.transforms.apply_1d`` on ``fft_backend``.
        """
        from ..core import transforms as ctf

        if mode == "decode":
            raise NotImplementedError(
                "fft_conv is a training-time mixer; decode uses "
                "ssm_impl='scan'")
        b_, s, d = x.shape
        dt = x.dtype

        xin, z = _channel_in(x, self.w_in, self.cfg.expand * d, rules)
        xin = shard(xin, rules, "batch", None, "tp")
        # implicit kernel h: (di, S) over this rank's channels
        t = torch.arange(s, dtype=torch.float32, device=x.device)
        # every channel reads the decay: partial gradients over "model"
        lam = F.softplus(tp_copy(self.decay, rules).float())  # (K,)
        basis = torch.exp(-lam[:, None] * t[None, :] / s)    # (K, S)
        h = self.basis_w.float() @ basis                     # (di, S)

        # zero-pad to 2S (linear, causal convolution): contiguous
        # (B, di, 2S) and (di, 2S) lines, so the kernel backend transforms
        # them in place with no line copy
        nfft = 2 * s
        xt = F.pad(xin.transpose(1, 2).float(), (0, nfft - s)) \
            .to(torch.complex64).contiguous()
        hp = F.pad(h, (0, nfft - s)).to(torch.complex64).contiguous()
        xf = ctf.apply_1d(xt, -1, "fft", backend=fft_backend)
        hf = ctf.apply_1d(hp, -1, "fft", backend=fft_backend)
        y = ctf.apply_1d(xf * hf[None], -1, "ifft",
                         backend=fft_backend).real[..., :s]
        y = y.transpose(1, 2).to(dt)
        y = y * F.silu(z)
        out = tp_sum(y @ use(self.w_out, rules).to(dt), rules)
        return shard(out, rules, "batch", None, None), None


def init_mlstm(b, path: str, cfg: ModelConfig) -> MLSTM:
    return MLSTM(b, path, cfg)


def init_slstm(b, path: str, cfg: ModelConfig) -> SLSTM:
    return SLSTM(b, path, cfg)


def init_mamba(b, path: str, cfg: ModelConfig) -> Mamba:
    return Mamba(b, path, cfg)


def init_fft_conv(b, path: str, cfg: ModelConfig,
                  n_basis: int = 16) -> FFTConv:
    return FFTConv(b, path, cfg, n_basis)


def mlstm(p: MLSTM, cfg: ModelConfig, rules: Optional[MeshRules],
          x: torch.Tensor, **kw):
    return p(x, rules=rules, **kw)


def slstm(p: SLSTM, cfg: ModelConfig, rules: Optional[MeshRules],
          x: torch.Tensor, **kw):
    return p(x, rules=rules, **kw)


def mamba(p: Mamba, cfg: ModelConfig, rules: Optional[MeshRules],
          x: torch.Tensor, **kw):
    return p(x, rules=rules, **kw)


def fft_conv(p: FFTConv, cfg: ModelConfig, rules: Optional[MeshRules],
             x: torch.Tensor, **kw):
    return p(x, rules=rules, **kw)
