# Port of repro/models/serve_app.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take and give numpy state, as the JAX app's do, so the copied crash
#   tester drives them unchanged.
# * The weights and the prompts come from CPU torch.Generators seeded with
#   ``seed`` and 7 (JAX's PRNGKey(seed) and PRNGKey(7) give other numbers),
#   made on the CPU and then moved, so the card and the CPU start from the
#   same weights.  Tests that need JAX's weights set ``_params`` and
#   ``_prompts`` (convert.params_from_jax).  The campaign outcomes and the
#   plan do not hang on which random weights the model has: the JAX app
#   gives the pinned counts and plan for seeds 0-3 alike.
# * The prefill keeps impl="reference", as the JAX app does, so the goldens
#   compare like with like.
# * No jit; the closures become methods, so the app pickles.
"""Autoregressive decode as an EasyCrash IterativeApp.

``launch/serve.py``'s decode loop, wrapped in the campaign abstraction so
S1–S4 rates and persist plans exist for *serving*, not just training.  One
main-loop iteration decodes one token for a batch of sessions:

    cache  — KV decode state, flattened to one vector
             (expected: critical — it is the session)
    tokens — the committed token buffer, prompt + generated
    next   — the staged not-yet-committed token        (temporal)
    k      — decode-step counter                       (always persisted)

Regions: ``decode`` (the transformer step + greedy argmax) and ``commit``
(append the staged token, advance the counter).

Intrinsic fault tolerance here is *bounded decode divergence*: a crash that
leaves a stale cache image in NVM restarts with the bookmarked step counter
but decode state from an earlier step — greedy decoding then re-derives the
stream, and acceptance verification is prefix/token match against the golden
stream (``match_frac``).

Registered in the port's suite registry as ``"decode"``
(:func:`repro_torch.hpc.suite.get_app`).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .config import ModelConfig, scaled_down
from .transformer import decode_step, init_cache, init_params, prefill


def _leaves(tree: Dict) -> List[torch.Tensor]:
    """Leaves in sorted-key order, as jax.tree.flatten orders a dict."""
    out: List[torch.Tensor] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _rebuild(tree: Dict, leaves: List[torch.Tensor]) -> Dict:
    it = iter(leaves)

    def go(t):
        return {k: go(t[k]) if isinstance(t[k], dict) else next(it) for k in sorted(t)}

    return go(tree)


def _tree_to(tree: Dict, device: str) -> Dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class DecodeApp(IterativeApp):
    name = "decode"
    candidates = ("cache", "tokens", "next", "k")
    iterator_object = "k"
    #: campaign fault tuning: each KV slot is written once and then read for
    #: the rest of the stream — ancient-but-large cold state, so spread bit
    #: flips wide; correlated failures should strike the dominant decode
    #: region where the cache is mid-update.
    fault_defaults = {
        "bit-flip": {"n_bits": 16},
        "correlated-region": {"shape": 3.0},
    }

    def __init__(
        self,
        base: ModelConfig = None,
        n_iters: int = 32,
        batch: int = 2,
        prompt_len: int = 8,
        width: int = 32,
        match_frac: float = 0.9,
        seed: int = 0,
        device: str = "cuda",
    ):
        from ..configs import get_arch

        base = base or get_arch("stablelm-1.6b")
        self.cfg = scaled_down(base, width=width)
        self.n_iters = n_iters
        self.batch = batch
        self.prompt_len = prompt_len
        self.max_len = prompt_len + n_iters + 1
        self.match_frac = match_frac
        self._seed = seed
        self.device = resolve_device(device)
        self._golden_tokens = None
        cfg = self.cfg
        self._params = _tree_to(init_params(cfg, torch.Generator().manual_seed(seed)), self.device)
        gen = torch.Generator().manual_seed(7)
        self._prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                                      dtype=torch.int32).to(self.device)
        template = init_cache(cfg, batch, self.max_len, self.device)
        self._template = {k: v for k, v in template.items() if k != "t"}
        self._shapes = [(tuple(l.shape), l.dtype) for l in _leaves(self._template)]
        self._sizes = [int(np.prod(s)) for s, _ in self._shapes]

    # ------------------------------------------------------------- plumbing
    def _unflatten(self, vec: torch.Tensor) -> Dict:
        out, off = [], 0
        for (shape, dt), size in zip(self._shapes, self._sizes):
            out.append(vec[off:off + size].reshape(shape).to(dt))
            off += size
        return _rebuild(self._template, out)

    @staticmethod
    def _flatten(tree: Dict) -> np.ndarray:
        flat = torch.cat([x.reshape(-1).float() for x in _leaves(tree)])
        return flat.cpu().numpy()

    def _t(self, t: int) -> torch.Tensor:
        return torch.tensor(t, dtype=torch.int32, device=self.device)

    # ----------------------------------------------------------------- state
    def init(self, seed: int = 0) -> State:
        cfg = self.cfg
        logits, pcache = prefill(cfg, self._params, self._prompts)  # impl="reference"
        from ..launch.serve import _splice_cache

        full = init_cache(cfg, self.batch, self.max_len, self.device)
        spliced = _splice_cache(cfg, full, pcache, self.prompt_len)
        spliced = {k: v for k, v in spliced.items() if k != "t"}
        first = logits.argmax(dim=-1).to(torch.int32)
        tokens = np.zeros((self.batch, self.max_len), np.int32)
        tokens[:, : self.prompt_len] = self._prompts.cpu().numpy()
        tokens[:, self.prompt_len] = first.cpu().numpy()
        return {
            "cache": self._flatten(spliced),
            "tokens": tokens,
            "next": np.zeros((self.batch, 1), np.int32),
            "k": np.zeros(1, np.int64),
        }

    def _region_decode(self, s: State) -> State:
        s = dict(s)
        t = self.prompt_len + int(s["k"][0])
        cache = self._unflatten(torch.from_numpy(np.array(s["cache"], np.float32)).to(self.device))
        cache["t"] = self._t(t)
        token = torch.from_numpy(np.array(s["tokens"][:, t:t + 1])).to(self.device)
        logits, new_cache = decode_step(self.cfg, self._params, token, cache)
        nxt = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
        s["cache"] = self._flatten({k: v for k, v in new_cache.items() if k != "t"})
        s["next"] = nxt.cpu().numpy()
        return s

    def _region_commit(self, s: State) -> State:
        s = dict(s)
        t = self.prompt_len + int(s["k"][0])
        tokens = np.array(s["tokens"], copy=True)
        tokens[:, t + 1] = s["next"][:, 0]
        s["tokens"] = tokens
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("decode", self._region_decode, writes=("cache", "next"),
                   reads=("cache", "tokens", "k"), cost=4.0,
                   hot_reads=("tokens",)),
            Region("commit", self._region_commit, writes=("tokens", "k"),
                   reads=("next", "tokens", "k"), cost=0.2),
        )

    # ----------------------------------------------------------- verification
    def _golden(self) -> np.ndarray:
        if self._golden_tokens is None:
            s = self.init(self._seed)
            for _ in range(self.n_iters):
                s = self.run_iteration(s)
            self._golden_tokens = np.array(s["tokens"], copy=True)
        return self._golden_tokens

    def _match_fraction(self, state: State) -> float:
        golden = self._golden()
        lo, hi = self.prompt_len, self.prompt_len + self.n_iters + 1
        got = np.asarray(state["tokens"])[:, lo:hi]
        want = golden[:, lo:hi]
        return float(np.mean(got == want))

    def verify(self, state: State) -> VerifyResult:
        frac = self._match_fraction(state)
        return VerifyResult(frac >= self.match_frac, frac,
                            detail=f"token match {frac:.3f}")

    def progress(self, state: State) -> float:
        # residual-style metric: divergence from the golden stream
        return 1.0 - self._match_fraction(state)
