"""Trace-driven benchmarking (paper §5.2 "Benchmark methodology").

The paper records each pipeline's per-stage input/output texts once (via
GPT-3.5) and then replays *real* LLM inference stopping at the recorded
output lengths — fixing the decoding workload so systems compare fairly.
We generate equivalent synthetic traces: per pipeline, a seeded sample of
stage sequences with generation lengths drawn from pipeline-specific
distributions, plus the rewrite strength that drives q_out drift.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.overlap import PIPELINE_SIGMA

PIPELINES = ("hyde", "subq", "iter", "irg", "flare", "self_rag")


@dataclass
class StageTrace:
    kind: str                   # "generate" | "retrieve" | "judge"
    gen_tokens: int = 0         # decode steps for generate/judge stages
    num_queries: int = 1        # parallel retrievals (SubQ sub-questions)


@dataclass
class RequestTrace:
    pipeline: str
    request_id: int
    stages: List[StageTrace]
    rewrite_sigma: float
    prompt_tokens: int = 64

    @property
    def rounds(self) -> int:
        """Number of retrieval rounds in the trace."""
        return sum(1 for s in self.stages if s.kind == "retrieve")

    @property
    def total_gen_tokens(self) -> int:
        """Decode tokens summed over every generate/judge stage."""
        return sum(s.gen_tokens for s in self.stages)

    def pre_retrieval_tokens(self) -> List[int]:
        """Generation tokens in each window that precedes a retrieval —
        the lookahead windows t_LLM (used for budget calibration)."""
        wins, acc = [], 0
        for s in self.stages:
            if s.kind == "retrieve":
                wins.append(acc)
                acc = 0
            else:
                acc += s.gen_tokens
        return wins or [0]


def _geo(rng: np.random.Generator, mean: float, lo: int = 4) -> int:
    return int(max(lo, rng.geometric(1.0 / max(mean, 1.0))))


def make_trace(pipeline: str, request_id: int, rng: np.random.Generator,
               length_scale: float = 1.0) -> RequestTrace:
    """One request's stage plan, mirroring Fig. 8's pipeline structures."""
    s = lambda m: _geo(rng, m * length_scale)
    st: List[StageTrace] = []
    if pipeline == "hyde":
        # hypothetical paragraph -> retrieval -> answer
        st = [StageTrace("generate", s(128)), StageTrace("retrieve"),
              StageTrace("generate", s(96))]
    elif pipeline == "subq":
        # 3-4 sub-questions generated, batched retrieval, one answer
        nq = int(rng.integers(3, 5))
        st = [StageTrace("generate", s(24) * nq),
              StageTrace("retrieve", num_queries=nq),
              StageTrace("generate", s(128))]
    elif pipeline == "iter":
        # iterative narrowing with judge, 2-3 iterations
        for _ in range(int(rng.integers(2, 4))):
            st += [StageTrace("generate", s(32)), StageTrace("retrieve"),
                   StageTrace("generate", s(64)), StageTrace("judge", s(8))]
    elif pipeline == "irg":
        # Iter-RetGen: exactly 3 retrieve+generate rounds, short outputs
        for _ in range(3):
            st += [StageTrace("retrieve"), StageTrace("generate", s(48))]
        # first round has no preceding generation window: prefetch uses the
        # prompt embedding itself (paper: post-retrieval generation serves
        # as the lookahead window for the next round)
    elif pipeline == "flare":
        # confidence-triggered retrieval per upcoming sentence
        for _ in range(int(rng.integers(2, 5))):
            st += [StageTrace("generate", s(28)), StageTrace("retrieve")]
        st.append(StageTrace("generate", s(48)))
    elif pipeline == "self_rag":
        # judge decides to retrieve; generate; self-critique
        st = [StageTrace("judge", s(8)), StageTrace("retrieve"),
              StageTrace("generate", s(96)), StageTrace("judge", s(16))]
    else:
        raise KeyError(pipeline)
    return RequestTrace(pipeline=pipeline, request_id=request_id, stages=st,
                        rewrite_sigma=PIPELINE_SIGMA[pipeline],
                        prompt_tokens=_geo(rng, 48 * length_scale, lo=8))


def make_traces(pipeline: str, n: int, *, seed: int = 0,
                length_scale: float = 1.0) -> List[RequestTrace]:
    """``n`` seeded traces for one pipeline (request ids 0..n-1 from
    one RNG stream, so a (pipeline, seed) pair fixes the workload)."""
    rng = np.random.default_rng(seed)
    return [make_trace(pipeline, i, rng, length_scale) for i in range(n)]


def calibration_windows(pipeline: str, n: int = 64, *, seed: int = 7,
                        length_scale: float = 1.0) -> List[int]:
    """The 64-sample profile the paper uses to set per-pipeline budgets."""
    toks: List[int] = []
    for t in make_traces(pipeline, n, seed=seed, length_scale=length_scale):
        toks.extend(t.pre_retrieval_tokens())
    return toks
