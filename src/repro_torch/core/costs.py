"""Cost models: the paper's Eq. 6 log-normalised heuristic plus a
FLOPs-derived pricing model that turns any framework architecture into a
portfolio arm with a realistic $/token rate.

The paper prices arms from API rate cards (Table 1, 530x spread). When the
portfolio is built from our own served architectures, we derive a blended
$/1k-token rate from active-parameter FLOPs at a market-calibrated $/FLOP
so that the same 2-3 orders-of-magnitude spread emerges naturally.
"""
from __future__ import annotations

import dataclasses

# Calibration: Llama-3.1-8B is served around $0.10 per 1M blended tokens
# (the paper's market floor). 8B params -> 2*8e9 FLOPs/token, so
#   $/FLOP ~= 1e-7 / (2 * 8e9 * 1e3)  per token-FLOP... we keep it simple:
#   price_per_1k_tokens = DOLLARS_PER_GFLOP_1K * active_gflops_per_token
_LLAMA8B_GFLOPS_PER_TOK = 2 * 8.0  # 16 GFLOP/token
_LLAMA8B_PRICE_PER_1K = 1e-4       # $0.1000/M = 1e-4 $/1k tokens
DOLLARS_PER_GFLOP_1K = _LLAMA8B_PRICE_PER_1K / _LLAMA8B_GFLOPS_PER_TOK


@dataclasses.dataclass(frozen=True)
class ArmPricing:
    """Blended pricing for one portfolio arm."""

    name: str
    price_per_1k: float        # blended $/1k tokens (Eq. 6 input)
    mean_req_tokens: float     # expected in+out tokens per request

    @property
    def price_per_req(self) -> float:
        return self.price_per_1k * self.mean_req_tokens / 1e3


def price_from_active_params(
    name: str,
    active_params: float,
    *,
    mean_req_tokens: float = 1000.0,
    margin: float = 1.0,
) -> ArmPricing:
    """FLOPs-derived blended rate: 2 * N_active FLOPs/token at the
    market-calibrated $/GFLOP. ``margin`` models provider markup."""
    gflops_per_tok = 2.0 * active_params / 1e9
    return ArmPricing(
        name=name,
        price_per_1k=margin * DOLLARS_PER_GFLOP_1K * gflops_per_tok,
        mean_req_tokens=mean_req_tokens,
    )


# The paper's Table 1 portfolio (exact numbers used by the repro benchmarks).
# Blended $/1k-token rates chosen so price_per_req matches Table 1 at the
# dataset's mean request length (~1k tokens); Llama sits on the market floor
# (c_tilde = 0 by construction, Appendix B).
PAPER_PORTFOLIO = (
    ArmPricing("llama-3.1-8b", price_per_1k=2.9e-5, mean_req_tokens=1000.0),
    ArmPricing("mistral-large", price_per_1k=5.3e-4, mean_req_tokens=1000.0),
    ArmPricing("gemini-2.5-pro", price_per_1k=1.5e-2, mean_req_tokens=1000.0),
)
# Onboarded fourth arm (§4.5): Gemini-2.5-Flash, between Mistral and Pro.
FLASH_PRICING = ArmPricing("gemini-2.5-flash", price_per_1k=1.1e-3,
                           mean_req_tokens=1000.0)

# Paper budget targets (Table 1).
BUDGET_TIGHT = 3.0e-4
BUDGET_MODERATE = 6.6e-4
BUDGET_LOOSE = 1.9e-3
