"""Seconds of the device SPR screen's host work in a tree job: the sum
over its passes (``batch_spr.stats.passes``) of ``collect_s + pack_s +
decide_s + apply_s``, the mean over the window's tree jobs that screened
on the device; nothing where none did."""


def read(rec):
    jobs = [j for j in rec.jobs if j["kind"] == "tree" and j["spr_passes"]]
    if not jobs:
        return None
    return sum(p["collect_s"] + p["pack_s"] + p["decide_s"] + p["apply_s"]
               for j in jobs for p in j["spr_passes"]) / len(jobs)
