"""PortfolioServer: ParetoBandit routing in front of really served models.

A portfolio of served models (any architecture of ``repro_torch.configs``
but the encoder-decoder one, whose prefill needs frames that
``generate`` does not pass), the feature pipeline (hash encoder + PCA),
Algorithm 1 arm selection, decoding on the chosen model, and closed-loop
bandit/pacer updates from the observed (reward, cost).

On the card, generation runs the models' attention through the CUDA
kernels (``flash_attention`` in prefill, ``decode_attention`` per token),
the SSM and hybrid models' prefill scan through ``ssd_scan``, and routing
through ``linucb_score``; on the CPU every kernel wrapper runs its plain
version.

``serve_batch`` is the batched data plane: the block is routed through
``RouterGateway.route_block`` (one ``select_batch`` against the live
state, the snapshot version recorded per request), generation is grouped
by chosen arm, and the block's feedback is enqueued to the learner plane
and applied by an immediate ``learn_tick`` (publish cadence 1). ``serve``
is its B = 1 case. Rewards come from a pluggable judge; offline that is
``SimulatedJudge``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import pacer, prng
from repro_torch.core import registry as registry_lib
from repro_torch.core.costs import ArmPricing
from repro_torch.core.features import PCAWhitener, hash_encode_batch
from repro_torch.core.types import (
    HYPER_FIELDS, HyperParams, RouterConfig, RouterState, init_state,
    resolve_device, with_hyperparams,
)
from repro_torch.models import decode_step, init_model, prefill_forward
from repro_torch.models.config import ModelConfig
from repro_torch.serving.gateway import RouterGateway
from repro_torch.serving.sampler import sample_token
from repro_torch.serving.tokenizer import HashTokenizer


@dataclasses.dataclass
class ServedModel:
    """One portfolio arm: a runnable model + its pricing."""

    name: str
    cfg: ModelConfig
    params: Dict
    pricing: ArmPricing
    tier: str = "mid"  # budget | mid | frontier (judge quality profile)

    @classmethod
    def init(cls, cfg: ModelConfig, pricing: ArmPricing, tier: str,
             seed: int = 0, *, device=None) -> "ServedModel":
        """Random weights from ``seed``, stored in the config's compute
        dtype (the values JAX's cast at use gives)."""
        params = init_model(cfg, seed=seed, device=device,
                            dtype=cfg.torch_dtype)
        return cls(name=cfg.name, cfg=cfg, params=params, pricing=pricing,
                   tier=tier)

    PROMPT_BUCKET = 32  # prompts are padded to a multiple of the bucket

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def generate(self, tokens: np.ndarray, max_new: int = 16,
                 key: Optional[torch.Tensor] = None,
                 temperature: float = 0.0) -> np.ndarray:
        """Prefill the prompt, then ``max_new`` decode steps; returns the
        ``max_new`` generated ids. The prompt is left-padded with BOS to a
        multiple of ``PROMPT_BUCKET`` and cut to its last 4 buckets (128
        tokens). ``key`` (a threefry key) is split once per token, as the
        JAX package does."""
        pad = (-len(tokens)) % self.PROMPT_BUCKET or (
            self.PROMPT_BUCKET if len(tokens) == 0 else 0)
        toks = np.concatenate([np.ones(pad, np.int32), tokens])[
            -4 * self.PROMPT_BUCKET:]
        toks = torch.as_tensor(toks[None, :], device=self.device)
        cache_len = toks.shape[1] + max_new
        logits, caches = prefill_forward(self.params, self.cfg, toks,
                                         cache_len=cache_len)
        out = []
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        if key is None:
            key = prng.PRNGKey(0)
        for _ in range(max_new):
            out.append(int(cur[0, 0]))
            logits, caches = decode_step(self.params, self.cfg, cur, caches)
            pair = prng.split(key)              # fresh key per sampled token
            key, sub = pair[0], pair[1]
            cur = sample_token(logits, sub, temperature=temperature)[:, None]
        return np.asarray(out, np.int32)


class SimulatedJudge:
    """Offline reward oracle: quality by (task family, model tier) + noise.
    Profiles mirror the simulator's calibrated matrix."""

    PROFILES = {
        # family:     budget  mid   frontier
        "math":       (0.69, 0.84, 0.96),
        "code":       (0.73, 0.86, 0.96),
        "reasoning":  (0.72, 0.85, 0.96),
        "knowledge":  (0.81, 0.985, 0.945),
        "commonsense": (0.87, 0.98, 0.93),
    }
    TIERS = ("budget", "mid", "frontier")

    def __init__(self, seed: int = 0, noise: float = 0.055):
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.overrides: Dict[str, float] = {}  # model name -> forced mean

    def score(self, family: str, model: ServedModel) -> float:
        if model.name in self.overrides:
            base = self.overrides[model.name]
        else:
            prof = self.PROFILES.get(family, self.PROFILES["reasoning"])
            base = prof[self.TIERS.index(model.tier)]
        return float(np.clip(base + self.noise * self.rng.standard_normal(),
                             0.0, 1.0))

    def degrade(self, model_name: str, mean: float):
        """Silently regress one model (§4.4 stress test)."""
        self.overrides[model_name] = mean

    def restore(self, model_name: str):
        self.overrides.pop(model_name, None)


@dataclasses.dataclass
class ServeResult:
    request_id: int
    model: str
    arm: int
    reward: float
    cost: float
    tokens_out: int
    route_us: float
    total_ms: float
    lam: float


class PortfolioServer:
    """Closed-loop serving: route -> generate -> judge -> update.

    The router state (S = 1) lives on ``device`` (default the card; the
    whitener must be on the same device)."""

    def __init__(
        self,
        models: List[ServedModel],
        whitener: PCAWhitener,
        budget: float,
        router_cfg: Optional[RouterConfig] = None,
        judge: Optional[SimulatedJudge] = None,
        max_new_tokens: int = 8,
        seed: int = 0,
        feedback_store=None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = router_cfg or RouterConfig()
        self.whitener = whitener
        self.judge = judge or SimulatedJudge(seed)
        self.max_new_tokens = max_new_tokens
        self.models: List[Optional[ServedModel]] = [None] * self.cfg.max_arms
        self._tokenizers: Dict[str, HashTokenizer] = {}  # per-model cache
        # The generation key chain stays on the host: one split per
        # request and per token, as in the JAX package.
        self._gen_key = prng.PRNGKey(seed ^ 0x5EED)
        prices = np.full(self.cfg.max_arms, 1e9, np.float32)
        state = init_state(
            self.cfg, prices, prices, budget,
            key=prng.PRNGKey(seed)[None], active=np.zeros(self.cfg.max_arms,
                                                          bool),
            device=self.device)
        self.gateway = RouterGateway(self.cfg, state, store=feedback_store)
        for i, m in enumerate(models):
            self.add_model(m, slot=i, forced_exploration=False)

    @property
    def state(self) -> RouterState:
        return self.gateway.live_state

    @property
    def dropped_feedback(self) -> int:
        return self.gateway.telemetry.counter("dropped_feedback")

    # -- portfolio management (hot swap, §3.6) ------------------------------
    def add_model(self, model: ServedModel, slot: Optional[int] = None,
                  n_eff: float = 0.0, forced_exploration: bool = True) -> int:
        if slot is None:
            active = self.state.active[0].cpu().numpy()
            slot = next(i for i, m in enumerate(self.models)
                        if m is None and not active[i])
        # Model first, state second: the instant the publish lands, a
        # selection may route to the slot.
        self.models[slot] = model
        self.gateway.apply_control(lambda s: registry_lib.add_arm(
            self.cfg, s, slot,
            model.pricing.price_per_req, model.pricing.price_per_1k,
            n_eff=n_eff or None, forced_exploration=forced_exploration,
        ))
        return slot

    def remove_model(self, slot: int) -> None:
        # State first, model second: no post-publish selection routes here.
        self.gateway.apply_control(
            lambda s: registry_lib.delete_arm(self.cfg, s, slot))
        self.models[slot] = None

    def set_budget(self, budget: float) -> None:
        self.gateway.apply_control(lambda s: dataclasses.replace(
            s, pacer=pacer.set_budget(s.pacer, budget)))

    def set_hyperparams(self, hyper: Optional[HyperParams] = None,
                        **overrides) -> HyperParams:
        """Retune the live router's hyper-parameters: a full
        ``HyperParams`` or field overrides (``srv.set_hyperparams(
        alpha=0.05)``), range-checked before they touch the state. Returns
        the now-live values."""
        self.gateway.apply_control(
            lambda s: with_hyperparams(s, hyper=hyper, **overrides))
        return self.hyperparams()

    def hyperparams(self) -> HyperParams:
        """The live hyper-parameters as floats (operator view)."""
        return HyperParams(**{n: float(getattr(self.state.hyper, n)[0])
                              for n in HYPER_FIELDS})

    def metrics(self) -> Dict[str, float]:
        """Operator metrics, all floats: feedback counters plus the
        gateway telemetry (pull rates, route latency, pacer dual, ...)."""
        return self.gateway.metrics()

    def prometheus_text(self) -> str:
        """Prometheus exposition-format scrape of the same telemetry."""
        return self.gateway.prometheus_text()

    # -- request path -------------------------------------------------------
    def featurize_batch(self, prompts: List[str]) -> torch.Tensor:
        return self.whitener(hash_encode_batch(prompts))

    def _tokenizer(self, model: ServedModel) -> HashTokenizer:
        tok = self._tokenizers.get(model.name)
        if tok is None or tok.vocab_size != model.cfg.vocab_size:
            tok = HashTokenizer(model.cfg.vocab_size)
            self._tokenizers[model.name] = tok
        return tok

    def serve(self, request: Dict, defer_feedback: bool = False) -> ServeResult:
        """Scalar serving: the B = 1 case of ``serve_batch``."""
        return self.serve_batch([request], defer_feedback=defer_feedback)[0]

    def serve_batch(self, requests: List[Dict],
                    defer_feedback: bool = False) -> List[ServeResult]:
        """Featurize the block, route it in one ``select_batch`` call,
        generate grouped by chosen arm, then feed the block's (reward,
        cost) back through ``update_batch``. With ``defer_feedback=True``
        the update is left to the caller (``feedback``/``feedback_batch``):
        contexts stay cached in the feedback store."""
        if not requests:
            return []
        if all(m is None for m in self.models):
            raise RuntimeError(
                "empty portfolio: no active arms to route to "
                "(add_model before serving)")
        t0 = time.perf_counter()
        B = len(requests)
        X = self.featurize_batch([r["prompt"] for r in requests])
        routed = self.gateway.route_block([r["id"] for r in requests], X)
        arms = routed.arms
        rewards = np.zeros(B, np.float32)
        costs = np.zeros(B, np.float32)
        results: List[Optional[ServeResult]] = [None] * B
        # Group generation by chosen arm (stable order within a group).
        for i in np.argsort(arms, kind="stable"):
            req, arm = requests[int(i)], int(arms[i])
            model = self.models[arm]
            prompt_ids = self._tokenizer(model).encode(req["prompt"])
            pair = prng.split(self._gen_key)
            self._gen_key, sub = pair[0], pair[1]
            out = model.generate(prompt_ids, self.max_new_tokens, key=sub)
            n_tokens = len(prompt_ids) + len(out)
            costs[i] = model.pricing.price_per_1k * n_tokens / 1e3
            rewards[i] = self.judge.score(
                req.get("family", "reasoning"), model)
            results[int(i)] = ServeResult(
                request_id=req["id"], model=model.name, arm=arm,
                reward=float(rewards[i]), cost=float(costs[i]),
                tokens_out=len(out), route_us=routed.route_us, total_ms=0.0,
                lam=routed.lam,
            )
        if not defer_feedback:
            self.feedback_batch(
                [r["id"] for r in requests], arms, rewards, costs)
        total_ms = (time.perf_counter() - t0) * 1e3
        return [dataclasses.replace(r, total_ms=total_ms) for r in results]

    def feedback(self, request_id: int, *, reward: float, cost: float,
                 arm: Optional[int] = None) -> None:
        """Asynchronous feedback for one request, using the (context, arm)
        cached at route time; the arm may be omitted."""
        arms = None if arm is None else np.asarray([arm])
        self.feedback_batch([request_id], arms,
                            np.asarray([reward]), np.asarray([cost]))

    def feedback_batch(self, request_ids: List[int], arms, rewards,
                       costs) -> None:
        """Apply a block of (possibly late) feedback in one
        ``update_batch`` call. Unknown, already-consumed and
        arm-unresolvable entries are skipped and counted in
        ``dropped_feedback``, never raised on."""
        if not len(request_ids):
            return
        if self.gateway.enqueue_feedback(request_ids, arms, rewards, costs):
            self.gateway.learn_tick()
