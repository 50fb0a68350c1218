"""Continuous batching over a session pool with idle/resume dynamics.

Counterpart of :mod:`repro.serving.scheduler`: the same numpy generator,
drawn from in the same order, so both packages schedule the same sessions.
Sessions are multi-turn: a turn decodes a burst of tokens, then the session
idles until its next turn (popularity ~ Zipf with drift). Idle sessions' KV
pages cool down and get demoted; resumed sessions must have their pages
promoted back.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Session:
    sid: int
    pages: list = field(default_factory=list)  # logical page ids
    tokens: int = 0
    pending: int = 0  # tokens left in the current turn

    def active(self) -> bool:
        return self.pending > 0


class ContinuousBatcher:
    """Pick up to max_batch active sessions per decode round; start new
    turns according to the popularity distribution."""

    def __init__(
        self,
        n_sessions: int,
        page_size: int,
        max_batch: int = 8,
        turn_tokens: tuple = (16, 64),
        resumes_per_round: float = 2.0,
        zipf_s: float = 1.1,
        seed: int = 0,
    ):
        self.rng = np.random.default_rng(seed)
        self.page_size = page_size
        self.max_batch = max_batch
        self.turn_tokens = turn_tokens
        self.resumes_per_round = resumes_per_round
        self.sessions = [Session(sid=i) for i in range(n_sessions)]
        w = 1.0 / np.power(np.arange(1, n_sessions + 1, dtype=np.float64), zipf_s)
        self.popularity = (w / w.sum())[self.rng.permutation(n_sessions)]
        self._next_page = 0

    def alloc_page(self) -> int:
        p = self._next_page
        self._next_page += 1
        return p

    def drift(self) -> None:
        """Popularity drift (new hot sessions): drives migration phases."""
        self.popularity = self.popularity[self.rng.permutation(len(self.popularity))]

    def start_turns(self) -> list:
        n = self.rng.poisson(self.resumes_per_round)
        resumed = []
        if n == 0:
            return resumed
        picks = self.rng.choice(
            len(self.sessions), size=n, p=self.popularity, replace=True
        )
        for sid in picks:
            s = self.sessions[sid]
            if not s.active():
                s.pending = int(self.rng.integers(*self.turn_tokens))
                resumed.append(s)
        return resumed

    def round_batch(self) -> list:
        """Active sessions scheduled this round."""
        act = [s for s in self.sessions if s.active()]
        return act[: self.max_batch]

    def commit_tokens(self, sess: Session, n: int) -> list:
        """Account n decoded tokens; returns newly allocated pages."""
        new_pages = []
        for _ in range(n):
            if sess.tokens % self.page_size == 0:
                p = self.alloc_page()
                sess.pages.append(p)
                new_pages.append(p)
            sess.tokens += 1
        sess.pending -= n
        return new_pages
