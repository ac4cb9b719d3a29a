"""The window's wall over the trees completed in it: the time to a
solution, from loading the alignment to the written tree."""


def read(rec):
    jobs = [j for j in rec.jobs if j["kind"] == "tree"]
    if not jobs:
        return None
    return rec.window_s / len(jobs)
