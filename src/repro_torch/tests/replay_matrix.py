"""Replay-idempotence test matrix (consumed by `python -m repro_torch.tools.lint`).

Every op registered in a handler table must be exactly-once under the
recovery protocol.  Ops whose replies carry a transno are
*reply-cache-covered*: the server journals the reply in the export's
last_rcvd slot, resends are answered from the cache and replays are
pruned at the committed cut — the lint pass verifies this statically and
skips them here.  Every op that does NOT bear a transno must appear
below with its idempotence mechanism; the lint `replay-coverage` rule
fails the build when a new op is registered without either.

Keys are the registering class (as the analyzer sees the AST), values
map op name -> mechanism.  `tests/test_replay_matrix.py` spot-checks the
non-obvious claims at runtime.
"""

READ_ONLY = "read-only: no server state changes, any re-execution is safe"
IDEMPOTENT_CONVERGE = ("idempotent: re-execution converges to the same "
                       "state (absolute targets / removal of absentees is "
                       "a no-op)")
SESSION = ("session handshake: connect/disconnect carry their own "
           "generation numbers; re-execution renegotiates, never corrupts")

REPLAY_MATRIX = {
    # ------------------------------------------------------- base target
    "Target": {
        "connect": SESSION,
        "disconnect": SESSION,
        "ping": READ_ONLY,
        "mon_collect": READ_ONLY,
        "recovery_close": "idempotent recovery verb: closing an already-"
                          "closed window is a no-op (VBR admits late "
                          "replays either way)",
    },
    # --------------------------------------------------------------- OST
    "OstTarget": {
        "connect": SESSION + " (grant re-derived from export state)",
        "disconnect": SESSION,
        "ping": READ_ONLY,
        "getattr": READ_ONLY,
        "read": READ_ONLY,
        "glimpse_bulk": READ_ONLY,
        "statfs": READ_ONLY,
        "list_objects": READ_ONLY,
        "sync": "idempotent: commit of an already-committed journal is "
                "a no-op",
        "llog_cancel": IDEMPOTENT_CONVERGE,
        "orphan_cleanup": "idempotent: destroys only objects above "
                          "last_used that still exist; a second pass "
                          "finds nothing",
        "grant_shrink": "idempotent: shrinks to an absolute 'keep' "
                        "target, so a resent shrink converges",
    },
    # --------------------------------------------------------------- MDS
    "MdsTarget": {
        "getattr": READ_ONLY,
        "getattr_bulk": READ_ONLY,
        "readdir": READ_ONLY,
        "statfs": READ_ONLY,
        "bucket_lookup": READ_ONLY,
        "dir_nonempty": READ_ONLY,
        "dep_records": READ_ONLY,
        "wbc_request": "read-only: a cache-grant decision; state changes "
                       "only when the client enqueues the subtree lock",
        "changelog_read": "read-only for the stream: the consumer "
                          "bookmark moves only via changelog_clear",
        "reint": "dispatcher: replies carry the dispatched _reint_* "
                 "handler's transno, so the batch rides the reply cache",
        "prealloc_fids": "idempotent-by-design: a lost range is leaked, "
                         "never reused (real FID sequence semantics)",
        "llog_cancel": IDEMPOTENT_CONVERGE,
        "revoke_dir_locks": "idempotent: revoking already-revoked client "
                            "locks is a no-op",
        "sync_commit": "idempotent: commit of an already-committed "
                       "journal is a no-op",
        "peer_rebooted": "idempotent: reconnect nudge; a second nudge "
                         "finds the import already FULL",
        "rollback_to": "idempotent recovery verb: undoing past the same "
                       "cut twice finds nothing left above it",
        "prune_history": "idempotent recovery verb: filtering retained "
                         "history to the same cut converges",
    },
    # --------------------------------------------------------------- DLM
    "LdlmNamespace": {
        "ldlm_cancel": "idempotent: cancel of an unknown lock handle "
                       "returns success (the holder already lost it)",
        "ldlm_locks_for": READ_ONLY,
    },
    "LockCallbackTarget": {
        "blocking_ast": "idempotent: an AST for a handle the client "
                        "already dropped answers 'unknown' and the "
                        "server reaps the stale lock",
        "glimpse_ast": READ_ONLY,
    },
    # -------------------------------------------------------------- COBD
    "CachingOst": {
        "read": READ_ONLY + " (cache population is not client-visible "
                            "state)",
    },
}
