"""Protocol messages (names follow the paper exactly)."""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any


class MsgType(enum.Enum):
    # client/backup -> primary
    HEALTH_UPDATE = "HEALTH_UPDATE"
    REQUEST_TASKS = "REQUEST_TASKS"
    RESULT = "RESULT"
    REPORT_HARD_TASK = "REPORT_HARD_TASK"
    LOG = "LOG"
    EXCEPTION = "EXCEPTION"
    BYE = "BYE"
    # primary -> client
    ACK = "ACK"                   # ack of a state-bearing client message
    GRANT_TASKS = "GRANT_TASKS"
    NO_FURTHER_TASKS = "NO_FURTHER_TASKS"
    APPLY_DOMINO_EFFECT = "APPLY_DOMINO_EFFECT"
    STOP = "STOP"
    RESUME = "RESUME"
    SWAP_QUEUES = "SWAP_QUEUES"
    # primary <-> backup coordination
    NEW_CLIENT = "NEW_CLIENT"
    CLIENT_TERMINATED = "CLIENT_TERMINATED"
    FORWARD = "FORWARD"           # copy of a client message, primary->backup
    BROADCAST = "BROADCAST"       # control broadcast notice, primary->backup
    RESYNC_REQUEST = "RESYNC_REQUEST"   # backup detected a replication gap
    SYNC_STATE = "SYNC_STATE"     # fresh snapshot, primary->backup (resync)
    # instance -> server bootstrap
    HANDSHAKE = "HANDSHAKE"


_seq = itertools.count()


@dataclass(slots=True)
class Message:
    type: MsgType
    sender: str
    # payload shape varies per MsgType (dict for task grants, tuple for
    # results, bytes for snapshots) — handlers narrow it at the use site
    body: Any = None
    seq: int = field(default_factory=lambda: next(_seq))
    # server->client messages carry a per-client logical counter so clients
    # can dedup the primary's message against the backup's mirror of it
    srv_seq: int | None = None
    # control broadcasts (STOP/RESUME) instead carry a control-plane
    # counter shared by all clients: one logical broadcast, one number —
    # per-client srv_seq is never consumed, so the backup's mirrored
    # srv_seq state cannot diverge from the primary's across broadcasts
    ctrl_seq: int | None = None

    def key(self):
        """Dedup key for the two-copy delivery protocol (client->server
        copies share the same Message.seq)."""
        return (self.sender, self.seq)
