"""files_read.audit: the codeword files the audit gather reads, the sum of
the `files` of every `store.read` under `server.audit.gather`, per audit.
It counts the samples drawn from the levels held in files: a level moved
into memory, or a sample read twice, shows here."""

from porla_bench import spans

UNDER = "client.audit/server.audit/server.audit.gather/"


def read(run):
    files = [s["attrs"]["files"] for s in run.spans
             if s["name"] == "store.read" and s["path"].startswith(UNDER)]
    return spans.per_op(run, "audit", sum(files)) if files else None
