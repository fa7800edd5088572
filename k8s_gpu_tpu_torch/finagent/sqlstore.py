"""Relational store — the PostgreSQL role, via stdlib sqlite: the port's
own copy of ``k8s_gpu_tpu/finagent/sqlstore.py``.

The reference provisions PostgreSQL with two tables and one seed row
(智能风控解决方案.md:99-161): `user_behavior_log` (id, user_id, event_time,
event_type, details) seeded with user_123's failed Face-ID login
(:150-156), and `user_complaints` (id, user_id, complaint_time,
complaint_details, status default 'open', :138-148).  Setup is idempotent
drop-and-recreate (:117-122).

The app's HTTP server runs ``/chat`` on many threads, and one sqlite
connection used by two threads at once fails ("bad parameter or other
API misuse", seen with eight concurrent complaints); the reference's
store shares its connection unguarded.  Here a lock serializes every use
of the connection.
"""

from __future__ import annotations

import datetime
import sqlite3
import threading
from dataclasses import dataclass

SEED_USER = "user_123"
SEED_EVENT_TIME = "2025-05-04 09:30:00"
SEED_DETAILS = "Login attempt failed using Face ID"


@dataclass
class BehaviorEvent:
    user_id: str
    event_time: str
    event_type: str
    details: str


class SqlStore:
    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        self.setup()

    def setup(self) -> None:
        """Idempotent drop-and-recreate + seed (reference :117-158)."""
        with self._lock:
            self._setup()

    def _setup(self) -> None:
        c = self._conn
        c.execute("DROP TABLE IF EXISTS user_complaints")
        c.execute("DROP TABLE IF EXISTS user_behavior_log")
        c.execute(
            """CREATE TABLE user_behavior_log (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                user_id TEXT NOT NULL,
                event_time TEXT NOT NULL,
                event_type TEXT,
                details TEXT)"""
        )
        c.execute(
            """CREATE TABLE user_complaints (
                id INTEGER PRIMARY KEY AUTOINCREMENT,
                user_id TEXT,
                complaint_time TEXT NOT NULL,
                complaint_details TEXT,
                status TEXT DEFAULT 'open')"""
        )
        c.execute(
            "INSERT INTO user_behavior_log (user_id, event_time, event_type,"
            " details) VALUES (?, ?, 'login', ?)",
            (SEED_USER, SEED_EVENT_TIME, SEED_DETAILS),
        )
        c.commit()

    # -- the two queries the complaint agent makes (reference :272-287) ----
    def latest_failed_event(self, user_id: str) -> BehaviorEvent | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT user_id, event_time, event_type, details"
                " FROM user_behavior_log"
                " WHERE user_id = ? AND details LIKE '%failed%'"
                " ORDER BY event_time DESC LIMIT 1",
                (user_id,),
            ).fetchone()
        return BehaviorEvent(*row) if row else None

    def insert_complaint(self, user_id: str, details: str,
                         when: datetime.datetime | None = None) -> str:
        ts = (when or datetime.datetime.now()).strftime("%Y-%m-%d %H:%M:%S")
        with self._lock:
            self._conn.execute(
                "INSERT INTO user_complaints (user_id, complaint_time,"
                " complaint_details) VALUES (?, ?, ?)",
                (user_id, ts, details),
            )
            self._conn.commit()
        return ts

    def complaints(self, user_id: str | None = None) -> list[tuple]:
        q = ("SELECT user_id, complaint_time, complaint_details, status"
             " FROM user_complaints")
        args: tuple = ()
        if user_id:
            q += " WHERE user_id = ?"
            args = (user_id,)
        with self._lock:
            return self._conn.execute(q + " ORDER BY id", args).fetchall()

    def log_event(self, ev: BehaviorEvent) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO user_behavior_log (user_id, event_time,"
                " event_type, details) VALUES (?, ?, ?, ?)",
                (ev.user_id, ev.event_time, ev.event_type, ev.details),
            )
            self._conn.commit()
