"""op_ms.audit: the window's audit time over its audits, in ms, from the
challenge to the client's verdict on the proof: the whole
`PorlaClient.audit` call, the server's work under it. A mean over a
host-bound op, it swings with the host's speed from run to run more than
an end-to-end bound can hold, so it stands here beside `audit_ms.p90`."""

from porla_bench import spans


def read(run):
    return spans.mean(spans.op_ms(run, "audit"))
