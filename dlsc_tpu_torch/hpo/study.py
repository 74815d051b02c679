"""Study / Trial objects with SQLite persistence.

The port's copy of ``dlsc_tpu/hpo/study.py``, with the same SQLite schema,
so that a study written by either package loads in the other.

Optuna-compatible surface for everything the reference uses
(reference: src/optimization/study_manager.py, optuna_trainer.py):
``study.optimize(objective, n_trials, timeout, callbacks)``,
``trial.suggest_float/int/categorical``, ``trial.report`` +
``trial.should_prune``, trial states, ``best_trial``, resumable storage with
``load_if_exists=True`` (study_manager.py:84-92), raw listing and deletion.
"""

from __future__ import annotations

import json
import sqlite3
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Sequence


class TrialPruned(Exception):
    """Raised inside an objective to mark the trial pruned."""


class TrialState:
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAIL = "FAIL"


@dataclass
class Trial:
    number: int
    study: "Study" = field(repr=False)
    params: dict[str, Any] = field(default_factory=dict)
    distributions: dict[str, dict] = field(default_factory=dict)
    intermediate_values: dict[int, float] = field(default_factory=dict)
    state: str = TrialState.RUNNING
    value: float | None = None
    user_attrs: dict[str, Any] = field(default_factory=dict)
    datetime_start: float = field(default_factory=time.time)
    datetime_complete: float | None = None

    # -- suggest API ----------------------------------------------------------
    def _suggest(self, name: str, dist: dict) -> Any:
        if name in self.params:
            return self.params[name]
        value = self.study.sampler.sample(self.study, name, dist)
        self.params[name] = value
        self.distributions[name] = dist
        self.study._persist_trial(self)
        return value

    def suggest_float(self, name: str, low: float, high: float, *,
                      log: bool = False, step: float | None = None) -> float:
        return float(self._suggest(name, {
            "type": "float", "low": low, "high": high, "log": log, "step": step,
        }))

    def suggest_int(self, name: str, low: int, high: int, *,
                    log: bool = False, step: int = 1) -> int:
        return int(self._suggest(name, {
            "type": "int", "low": low, "high": high, "log": log, "step": step,
        }))

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, {"type": "categorical", "choices": list(choices)})

    # -- pruning hooks ------------------------------------------------------------
    def report(self, value: float, step: int) -> None:
        self.intermediate_values[int(step)] = float(value)
        self.study._persist_trial(self)

    def should_prune(self) -> bool:
        return self.study.pruner.prune(self.study, self)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value
        self.study._persist_trial(self)

    @property
    def last_step(self) -> int | None:
        return max(self.intermediate_values) if self.intermediate_values else None


_SCHEMA = """
CREATE TABLE IF NOT EXISTS studies (
    study_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_name TEXT UNIQUE NOT NULL,
    direction TEXT NOT NULL,
    created REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS trials (
    trial_id INTEGER PRIMARY KEY AUTOINCREMENT,
    study_id INTEGER NOT NULL,
    number INTEGER NOT NULL,
    state TEXT NOT NULL,
    value REAL,
    params TEXT NOT NULL,
    distributions TEXT NOT NULL,
    intermediate TEXT NOT NULL,
    user_attrs TEXT NOT NULL,
    datetime_start REAL,
    datetime_complete REAL,
    UNIQUE (study_id, number)
);
"""


def _parse_storage(storage: str | Path | None) -> Path:
    if storage is None:
        return Path("optuna_studies.db")
    s = str(storage)
    if s.startswith("sqlite:///"):
        s = s[len("sqlite:///"):]
    return Path(s)


class Study:
    def __init__(
        self,
        study_name: str,
        storage: str | Path | None = None,
        direction: str = "maximize",
        sampler=None,
        pruner=None,
        load_if_exists: bool = True,
    ):
        from dlsc_tpu_torch.hpo.pruners import NopPruner
        from dlsc_tpu_torch.hpo.tpe import TPESampler

        self.study_name = study_name
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or NopPruner()
        self.db_path = _parse_storage(storage)
        self.db_path.parent.mkdir(parents=True, exist_ok=True)
        # Concurrent-writer hardening: WAL + busy timeout + autocommit with
        # explicit BEGIN IMMEDIATE transactions where atomicity matters
        # (reference resume pattern runs multiple processes against one db,
        # study_manager.py:84-92).
        self._conn = sqlite3.connect(self.db_path, timeout=30.0,
                                     isolation_level=None)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA busy_timeout=30000")
        self._conn.executescript(_SCHEMA)
        # race-safe exclusive create: INSERT OR IGNORE is the atomic
        # exists-check — rowcount 1 means this process created the study,
        # 0 means it already existed (possibly created a microsecond ago by
        # a concurrent process; a separate SELECT-then-INSERT would let both
        # creators silently succeed)
        created = self._conn.execute(
            "INSERT OR IGNORE INTO studies (study_name, direction, created)"
            " VALUES (?,?,?)",
            (study_name, direction, time.time()),
        ).rowcount == 1
        if not created and not load_if_exists:
            raise ValueError(f"study {study_name!r} already exists")
        self._id, self.direction = self._conn.execute(
            "SELECT study_id, direction FROM studies WHERE study_name=?",
            (study_name,),
        ).fetchone()
        self._trials: dict[int, Trial] = {}
        self._owned: set[int] = set()  # trial numbers allocated by this process
        self._load_trials()

    # -- storage --------------------------------------------------------------
    def _load_trials(self) -> None:
        """Refresh trials from the db. Trials owned by this process keep
        their in-memory objects (authoritative here); everything else —
        including other processes' trials — is (re)loaded."""
        for (number, state, value, params, dists, inter, attrs, t0, t1) in (
            self._conn.execute(
                "SELECT number, state, value, params, distributions, intermediate,"
                " user_attrs, datetime_start, datetime_complete FROM trials"
                " WHERE study_id=? ORDER BY number", (self._id,),
            )
        ):
            if number in self._owned:
                continue
            t = Trial(
                number=number, study=self, state=state, value=value,
                params=json.loads(params), distributions=json.loads(dists),
                intermediate_values={int(k): v for k, v in json.loads(inter).items()},
                user_attrs=json.loads(attrs),
                datetime_start=t0, datetime_complete=t1,
            )
            self._trials[number] = t

    def _persist_trial(self, trial: Trial) -> None:
        self._conn.execute(
            "INSERT INTO trials (study_id, number, state, value, params,"
            " distributions, intermediate, user_attrs, datetime_start,"
            " datetime_complete) VALUES (?,?,?,?,?,?,?,?,?,?)"
            " ON CONFLICT (study_id, number) DO UPDATE SET state=excluded.state,"
            " value=excluded.value, params=excluded.params,"
            " distributions=excluded.distributions,"
            " intermediate=excluded.intermediate, user_attrs=excluded.user_attrs,"
            " datetime_complete=excluded.datetime_complete",
            (
                self._id, trial.number, trial.state, trial.value,
                json.dumps(trial.params), json.dumps(trial.distributions),
                json.dumps(trial.intermediate_values), json.dumps(trial.user_attrs),
                trial.datetime_start, trial.datetime_complete,
            ),
        )
        self._conn.commit()

    # -- trial lifecycle --------------------------------------------------------
    def ask(self) -> Trial:
        """Allocate the next trial number atomically: BEGIN IMMEDIATE takes
        the write lock before reading MAX(number), so concurrent askers can't
        collide on UNIQUE(study_id, number). Also refreshes other processes'
        trials so the sampler sees the full cross-process history."""
        for attempt in range(20):
            try:
                self._conn.execute("BEGIN IMMEDIATE")
                number = self._conn.execute(
                    "SELECT COALESCE(MAX(number)+1, 0) FROM trials"
                    " WHERE study_id=?", (self._id,),
                ).fetchone()[0]
                t = Trial(number=number, study=self)
                self._conn.execute(
                    "INSERT INTO trials (study_id, number, state, value, params,"
                    " distributions, intermediate, user_attrs, datetime_start,"
                    " datetime_complete) VALUES (?,?,?,?,?,?,?,?,?,?)",
                    (self._id, t.number, t.state, t.value, "{}", "{}", "{}",
                     "{}", t.datetime_start, None),
                )
                self._conn.execute("COMMIT")
            except sqlite3.Error:
                try:
                    self._conn.execute("ROLLBACK")
                except sqlite3.Error:
                    pass
                time.sleep(0.01 * (attempt + 1))
                continue
            self._owned.add(number)
            self._load_trials()
            self._trials[number] = t
            return t
        raise RuntimeError("ask(): could not allocate a trial number "
                           f"(db contended: {self.db_path})")

    def tell(self, trial: Trial, value: float | None, state: str) -> None:
        trial.value = value if value is None else float(value)
        trial.state = state
        trial.datetime_complete = time.time()
        self._persist_trial(trial)

    # -- queries ------------------------------------------------------------------
    @property
    def trials(self) -> list[Trial]:
        return [self._trials[n] for n in sorted(self._trials)]

    def trials_by_state(self, state: str) -> list[Trial]:
        return [t for t in self.trials if t.state == state]

    @property
    def best_trial(self) -> Trial:
        done = [t for t in self.trials if t.state == TrialState.COMPLETE
                and t.value is not None]
        if not done:
            raise ValueError("no completed trials")
        key = (max if self.direction == "maximize" else min)
        return key(done, key=lambda t: t.value)

    @property
    def best_value(self) -> float:
        return self.best_trial.value

    @property
    def best_params(self) -> dict:
        return dict(self.best_trial.params)

    # -- optimize loop ------------------------------------------------------------
    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int | None = None,
        timeout: float | None = None,
        callbacks: Sequence[Callable[["Study", Trial], None]] = (),
        catch: tuple = (Exception,),
    ) -> None:
        """Sequential trial loop: failed trials are recorded FAILED and the
        sweep continues (reference: optuna_trainer.py:149-154)."""
        start = time.time()
        done = 0
        while True:
            if n_trials is not None and done >= n_trials:
                break
            if timeout is not None and time.time() - start > timeout:
                break
            trial = self.ask()
            try:
                value = objective(trial)
                self.tell(trial, value, TrialState.COMPLETE)
            except TrialPruned:
                last = trial.intermediate_values.get(trial.last_step)
                self.tell(trial, last, TrialState.PRUNED)
            except catch as e:
                print(f"[hpo] trial {trial.number} FAILED: {e}")
                traceback.print_exc()
                self.tell(trial, None, TrialState.FAIL)
            for cb in callbacks:
                cb(self, trial)
            done += 1

    def summary(self) -> dict:
        by_state = {s: len(self.trials_by_state(s)) for s in
                    (TrialState.COMPLETE, TrialState.PRUNED,
                     TrialState.FAIL, TrialState.RUNNING)}
        out = {
            "study_name": self.study_name,
            "direction": self.direction,
            "n_trials": len(self.trials),
            "states": by_state,
        }
        try:
            best = self.best_trial
            out["best_value"] = best.value
            out["best_number"] = best.number
            out["best_params"] = best.params
        except ValueError:
            pass
        return out


class StudyManager:
    """Study lifecycle over a SQLite file (reference: study_manager.py:21-247):
    lazily-built sampler/pruner, create-or-resume, list, summarize, delete."""

    def __init__(
        self,
        study_name: str = "study",
        storage_path: str = "sqlite:///optuna_studies.db",
        direction: str = "maximize",
        sampler_config: dict | None = None,
        pruner_config: dict | None = None,
    ):
        self.study_name = study_name
        self.storage_path = storage_path
        self.direction = direction
        self.sampler_config = sampler_config or {}
        self.pruner_config = pruner_config or {}

    def _build_sampler(self):
        from dlsc_tpu_torch.config import instantiate

        cfg = dict(self.sampler_config)
        if "_target_" in cfg:
            return instantiate(cfg)
        from dlsc_tpu_torch.hpo.tpe import TPESampler

        # reference defaults: study_manager.py:58-67
        return TPESampler(n_startup_trials=cfg.get("n_startup_trials", 10),
                          n_ei_candidates=cfg.get("n_ei_candidates", 24),
                          seed=cfg.get("seed", 42))

    def _build_pruner(self):
        from dlsc_tpu_torch.config import instantiate

        cfg = dict(self.pruner_config)
        if "_target_" in cfg:
            return instantiate(cfg)
        from dlsc_tpu_torch.hpo.hyperband import HyperbandPruner

        # reference defaults: study_manager.py:69-78
        return HyperbandPruner(min_resource=cfg.get("min_resource", 1),
                               max_resource=cfg.get("max_resource", 100),
                               reduction_factor=cfg.get("reduction_factor", 3))

    def create_study(self, load_if_exists: bool = True) -> Study:
        return Study(
            self.study_name, self.storage_path, self.direction,
            sampler=self._build_sampler(), pruner=self._build_pruner(),
            load_if_exists=load_if_exists,
        )

    def load_study(self) -> Study:
        return self.create_study(load_if_exists=True)

    def list_studies(self) -> list[dict]:
        db = _parse_storage(self.storage_path)
        if not db.exists():
            return []
        conn = sqlite3.connect(db)
        rows = conn.execute(
            "SELECT s.study_name, s.direction, COUNT(t.trial_id)"
            " FROM studies s LEFT JOIN trials t ON t.study_id = s.study_id"
            " GROUP BY s.study_id"
        ).fetchall()
        conn.close()
        return [{"study_name": r[0], "direction": r[1], "n_trials": r[2]} for r in rows]

    def delete_study(self, study_name: str | None = None) -> None:
        name = study_name or self.study_name
        db = _parse_storage(self.storage_path)
        conn = sqlite3.connect(db)
        row = conn.execute(
            "SELECT study_id FROM studies WHERE study_name=?", (name,)
        ).fetchone()
        if row:
            conn.execute("DELETE FROM trials WHERE study_id=?", (row[0],))
            conn.execute("DELETE FROM studies WHERE study_id=?", (row[0],))
            conn.commit()
        conn.close()

    @classmethod
    def from_config(cls, cfg: dict) -> "StudyManager":
        """Build from the ``optuna:`` config block (reference:
        study_manager.py:230-247, configs/optimization.yaml)."""
        cfg = dict(cfg)
        return cls(
            study_name=cfg.get("study_name", "study"),
            storage_path=cfg.get("storage_path", "sqlite:///optuna_studies.db"),
            direction=cfg.get("direction", "maximize"),
            sampler_config=cfg.get("sampler") or {},
            pruner_config=cfg.get("pruner") or {},
        )
