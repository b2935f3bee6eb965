# Port of repro/models/train_app.py.  What differs:
# * The app computes on ``self.device`` (CUDA unless device="cpu"); regions
#   take numpy state to numpy state, as the JAX app's do, and keep a tensor
#   state on its device (the deployment loop's).
# * The initial weights and the token batches come from CPU
#   torch.Generators, seeded with ``seed`` and with 9000 and the batch's key
#   (JAX's PRNGKey(seed) and fold_in(PRNGKey(9000), key) give other
#   numbers), made on the CPU and then moved, so the card and the CPU train
#   from the same weights on the same tokens.
# * Unlike decode's, this app's campaign outcomes hang on its weights: the
#   JAX app gives S1 counts 8, 8, 7, 7 for seeds 0-3 (one lane ends near the
#   loss band).  So the app takes its initial parameter vector and its
#   token batches from outside (use_sources): the CPU tests give it the JAX
#   app's, converted, and hold it to the JAX pin; by default it keeps the
#   seeded torch generators, whose outcomes are the port's own.
# * The gradient is torch.autograd through loss_and_aux(impl="reference"),
#   as grad_fn differentiates the reference path in JAX.  Batched lanes run
#   the serial gradient one lane at a time (no vmap, no bmm: other
#   reduction tilings), so each lane is bitwise the serial one.
# * The Adam math is the JAX app's numpy code for numpy state; for a tensor
#   state the same expressions in torch, in the same order, each op rounded
#   to float32 (scalars taken to float32 first, as NumPy's weak Python
#   scalars are, divisors passed as device tensors so that no kernel
#   multiplies by a reciprocal instead, and the square root taken in
#   float64 and rounded, since torch's float32 sqrt on the CPU is not
#   correctly rounded and NumPy's is).
# * No jit and no closures, so the app pickles (the JAX app does not).
"""LM training as an EasyCrash IterativeApp.

This closes the loop between the paper and the LM substrate: SGD/Adam
training *is* one of the paper's "naturally resilient iterative methods"
(§2.2 cites k-means and CNN training), so the crash-test machinery runs on a
reduced transformer exactly like on CG/MG.

Data objects (the paper's granularity is whole objects, so parameter /
moment trees flatten to one vector each):

    params — the weights            (expected: critical)
    mu, nu — Adam moments           (expected: non-critical — they re-warm)
    grads  — last gradient          (temporal)
    k      — step counter           (always persisted)

Regions mirror the paper's first-level loop structure of one optimizer
step: ``grads`` (fwd+bwd), ``moments`` (Adam moment accumulation), and
``apply`` (bias-corrected parameter update + bookkeeping).  Acceptance
verification: eval loss within a band of the golden run's final loss —
fidelity-threshold acceptance, the ML analogue of a convergence test.

Registered in the port's suite registry as ``"lm-train"``
(:func:`repro_torch.hpc.suite.get_app`).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core.regions import IterativeApp, Region, State, VerifyResult
from ..device import resolve_device
from .config import ModelConfig, scaled_down
from .serve_app import _leaves, _rebuild
from .transformer import init_params, loss_and_aux

_B1, _B2, _EPS = 0.9, 0.95, 1e-8
#: the keys of the four eval batches
EVAL_KEYS = tuple(100_000 + i for i in range(4))


def _synthetic_batch(key_int: int, batch: int, seq: int, vocab: int) -> torch.Tensor:
    """Learnable stream: affine next-token map with 10% noise; (batch,
    seq + 1) int32 on the CPU."""
    gen = torch.Generator().manual_seed((9000 << 32) + int(key_int))
    t0 = torch.randint(0, vocab, (batch, 1), generator=gen)
    toks = [t0]
    tok = t0
    for _ in range(seq):
        tok = (tok * 7 + 3) % vocab
        toks.append(tok)
    tokens = torch.cat(toks, dim=1)
    noise = torch.rand(tokens.shape, generator=gen) < 0.1
    rand = torch.randint(0, vocab, tokens.shape, generator=gen)
    return torch.where(noise, rand, tokens).to(torch.int32)


def _skeleton(tree: Dict) -> Dict:
    """The tree's keys with None leaves (what _rebuild needs)."""
    return {k: _skeleton(v) if isinstance(v, dict) else None for k, v in tree.items()}


class LMTrainApp(IterativeApp):
    name = "lm-train"
    candidates = ("params", "mu", "nu", "k")
    iterator_object = "k"
    #: campaign fault tuning: the parameter vector is the one chronically
    #: dirty hot object (read by fwd+bwd every step, rewritten every apply),
    #: so silent corruption there is the interesting SDC surface, and
    #: correlated failures should concentrate in the dominant grads region.
    fault_defaults = {
        "bit-flip": {"n_bits": 8},
        "correlated-region": {"shape": 3.0},
    }

    def __init__(
        self,
        base: ModelConfig = None,
        n_iters: int = 40,
        batch: int = 8,
        seq: int = 32,
        lr: float = 2e-2,
        loss_band: float = 1.05,
        width: int = 64,
        seed: int = 0,
        device: str = "cuda",
    ):
        from ..configs import get_arch

        base = base or get_arch("stablelm-1.6b")
        self.cfg = scaled_down(base, width=width)
        self.n_iters = n_iters
        self.batch = batch
        self.seq = seq
        self.lr = lr
        self.loss_band = loss_band
        self._seed = seed
        self.device = resolve_device(device)
        self._golden_loss: Optional[float] = None
        p0 = init_params(self.cfg, torch.Generator().manual_seed(seed))
        leaves = _leaves(p0)
        self._skeleton = _skeleton(p0)
        self._shapes = [(tuple(l.shape), l.dtype) for l in leaves]
        self._sizes = [int(np.prod(s)) for s, _ in self._shapes]
        self._init_vec = torch.cat([l.reshape(-1).float() for l in leaves]).numpy()
        #: injected token batches by key (use_sources); None: the generators
        self._batches: Optional[Dict[int, np.ndarray]] = None

    # ------------------------------------------------------------- plumbing
    def use_sources(self, params: Optional[np.ndarray] = None,
                    batches: Optional[Mapping[int, np.ndarray]] = None) -> None:
        """Take the initial parameter vector (float32, the flattened tree in
        the JAX leaf order) and/or the token batches ({key: (batch, seq + 1)
        ints}: the training batch of step k under key k, the eval batches
        under EVAL_KEYS) from outside.  With batches given, a key missing
        from them raises KeyError."""
        if params is not None:
            vec = np.array(params, np.float32).reshape(-1)
            if vec.size != sum(self._sizes):
                raise ValueError(f"parameter vector of {vec.size} values, the model has "
                                 f"{sum(self._sizes)}")
            self._init_vec = vec
        if batches is not None:
            self._batches = {int(k): np.array(v, np.int32) for k, v in batches.items()}
        self._golden_loss = None

    def _batch(self, key: int) -> torch.Tensor:
        if self._batches is None:
            tokens = _synthetic_batch(key, self.batch, self.seq, self.cfg.vocab)
        else:
            tokens = torch.from_numpy(self._batches[key])
        return tokens.to(self.device)

    def _unflatten(self, vec: torch.Tensor) -> Dict:
        out: List[torch.Tensor] = []
        off = 0
        for (shape, dt), size in zip(self._shapes, self._sizes):
            out.append(vec[off:off + size].reshape(shape).to(dt))
            off += size
        return _rebuild(self._skeleton, out)

    def _vec(self, params) -> torch.Tensor:
        """A fresh float32 copy of a parameter vector on the device (its own
        allocation, so every lane's product sees the same alignment)."""
        if isinstance(params, torch.Tensor):
            return params.detach().to(self.device, torch.float32, copy=True)
        return torch.from_numpy(np.array(params, np.float32)).to(self.device, copy=True)

    def _loss(self, vec: torch.Tensor, key: int) -> torch.Tensor:
        return self._loss_on(vec, self._batch(key))

    def _loss_on(self, vec: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        loss, _ = loss_and_aux(self.cfg, self._unflatten(vec), {"tokens": tokens})
        return loss

    def _grad(self, params, key: int) -> torch.Tensor:
        return self._grad_on(params, self._batch(key))

    def _grad_on(self, params, tokens: torch.Tensor) -> torch.Tensor:
        vec = self._vec(params).requires_grad_(True)
        (g,) = torch.autograd.grad(self._loss_on(vec, tokens), vec)
        return g

    def _eval(self, params) -> float:
        with torch.no_grad():
            vec = self._vec(params)
            return float(torch.stack([self._loss(vec, key) for key in EVAL_KEYS]).mean())

    # ----------------------------------------------------------------- state
    def init(self, seed: int = 0) -> State:
        vec = np.array(self._init_vec, copy=True)
        return {
            "params": vec,
            "mu": np.zeros_like(vec),
            "nu": np.zeros_like(vec),
            "grads": np.zeros_like(vec),
            "k": np.zeros(1, np.int64),
        }

    def _region_grads(self, s: State) -> State:
        s = dict(s)
        g = self._grad(s["params"], int(s["k"][0]))
        s["grads"] = g if isinstance(s["grads"], torch.Tensor) else g.cpu().numpy()
        return s

    def _region_moments(self, s: State) -> State:
        s = dict(s)
        g = s["grads"]
        # the same expressions for numpy and torch: each op rounds to
        # float32, the Python scalars taken to float32 first
        s["mu"] = _B1 * s["mu"] + (1 - _B1) * g
        s["nu"] = _B2 * s["nu"] + (1 - _B2) * g * g
        return s

    def _region_apply(self, s: State) -> State:
        s = dict(s)
        t = int(s["k"][0]) + 1
        mu, nu, params = s["mu"], s["nu"], s["params"]
        if isinstance(params, torch.Tensor):
            def c(x):  # a float32 device scalar: a true division, not a reciprocal
                return torch.tensor(np.float32(x), device=params.device)

            mu_hat = mu / c(1 - _B1 ** t)
            nu_hat = nu / c(1 - _B2 ** t)
            # numpy's float32 sqrt is correctly rounded and torch's CPU one is
            # not; the float64 root rounded to float32 is (53 >= 2 * 24 + 2)
            root = torch.sqrt(nu_hat.double()).float()
            s["params"] = params - self.lr * mu_hat / (root + _EPS)
        else:
            mu_hat = mu / (1 - _B1 ** t)
            nu_hat = nu / (1 - _B2 ** t)
            s["params"] = params - self.lr * mu_hat / (np.sqrt(nu_hat) + _EPS)
        s["k"] = s["k"] + 1
        return s

    def regions(self) -> Tuple[Region, ...]:
        return (
            Region("grads", self._region_grads, writes=("grads",),
                   reads=("params", "k"), cost=3.0, hot_reads=("params",)),
            Region("moments", self._region_moments, writes=("mu", "nu"),
                   reads=("grads", "mu", "nu"), cost=1.0),
            Region("apply", self._region_apply, writes=("params", "k"),
                   reads=("mu", "nu", "params", "k"), cost=1.0),
        )

    # ------------------------------------------------------- batched recompute
    # The gradient (the expensive part) runs the serial function per lane;
    # the Adam math replays the serial numpy regions per lane, so every lane
    # is bitwise the serial trajectory.
    supports_batched_step = True

    def batched_kernels(self):
        from ..core.regions import BatchedKernel

        s = self.init(0)
        vecs = self._vec(np.stack([s["params"]] * 2))
        # each lane's batch comes from its step key, a host int that
        # run_iteration_batch reads from the lane's state: static
        # configuration, made outside the kernel and closed over
        batches = [self._batch(k) for k in (0, 0)]
        return (
            BatchedKernel("vgrad_batch",
                          lambda vs: torch.stack([self._grad_on(v, t)
                                                  for v, t in zip(vs, batches)]),
                          (vecs,), {0: 0}),
        )

    def run_iteration_batch(self, states):
        grads = [self._grad(s["params"], int(s["k"][0])).cpu().numpy() for s in states]
        out = []
        for g, s in zip(grads, states):
            s = dict(s)
            s["grads"] = g
            s = self._region_moments(s)
            s = self._region_apply(s)
            out.append(s)
        return out

    # ----------------------------------------------------------- verification
    def _golden(self) -> float:
        if self._golden_loss is None:
            s = self.init(self._seed)
            for _ in range(self.n_iters):
                s = self.run_iteration(s)
            self._golden_loss = self._eval(s["params"])
        return self._golden_loss

    def verify(self, state: State) -> VerifyResult:
        loss = self._eval(state["params"])
        target = self._golden() * self.loss_band
        return VerifyResult(bool(np.isfinite(loss) and loss <= target), loss)

    def progress(self, state: State) -> float:
        return self._eval(state["params"])
