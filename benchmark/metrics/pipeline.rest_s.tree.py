"""Seconds of a tree job outside ``Run.timings``' finding, placing and
topology (loading, the post-placement EM and branch lengths, the root
search, the writes), the mean over the window's tree jobs."""


def read(rec):
    jobs = [j for j in rec.jobs if j["kind"] == "tree"]
    if not jobs:
        return None
    return sum(j["wall_s"] - sum(j["timings"].values()) for j in jobs) \
        / len(jobs)
