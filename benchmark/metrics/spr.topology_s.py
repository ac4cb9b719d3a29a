"""Seconds of the SPR rounds in a tree job (``Run.timings["topology"]``),
the mean over the window's tree jobs."""


def read(rec):
    jobs = [j for j in rec.jobs if j["kind"] == "tree"]
    if not jobs:
        return None
    return sum(j["timings"]["topology"] for j in jobs) / len(jobs)
