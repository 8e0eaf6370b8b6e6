"""launches.update: launches of the port's kernels (the sum of
`native.KERNELS[*].launches`) per update."""


def read(run):
    ops = [op for op in run.ops if op["kind"] == "update" and op["ok"]]
    if not ops:
        return None
    return sum(op["launches"] for op in ops) / len(ops)
