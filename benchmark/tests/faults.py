"""Faults planted in the port underneath a run of a tree cell, each where
its work is produced:

- ``state_unchanged``: a placement step of the engine returns with the
  tree as it found it (its batch not placed);
- ``half_batch``: every placement step places half of its batch;
- ``answer_altered``: the placed tree comes out of the engine with two
  leaves' names swapped;
- ``spr_skipped``: every SPR pass and subround returns the tree unchanged;
- ``screen_empty``: the device SPR screen ranks no candidate;
- ``em_skipped``: the EM passes leave the rates as placement estimated
  them;
- ``rates_initial``: the rates stay at their starting values.
"""

FAULTS = ("state_unchanged", "half_batch", "answer_altered", "spr_skipped",
          "screen_empty", "em_skipped", "rates_initial")
QUALITY = ("spr_skipped", "screen_empty", "em_skipped", "rates_initial")


def plant(monkeypatch, fault):
    """Break the port for ``fault``; returns the list of the placement
    steps' batch sizes, filled as the run places."""
    from maple_tpu_torch.native.engine import NativePlacementEngine
    from maple_tpu_torch.parallel import batch_spr
    from maple_tpu_torch.pipeline import Run
    from maple_tpu_torch.refdata import Model
    from maple_tpu_torch.search import spr
    place = NativePlacementEngine.place_batch_seeded
    export = NativePlacementEngine.export_to_tree
    screen = batch_spr.spr_screen_step
    calls = []

    def place_seeded(self, vids, num, seeds, *args, **kwargs):
        calls.append(len(vids))
        if fault == "state_unchanged" and len(calls) == 2:
            return None
        if fault == "half_batch":
            k = max(1, len(vids) // 2)
            vids, seeds = vids[:k], seeds[:k]
        return place(self, vids, num, seeds, *args, **kwargs)

    def export_to_tree(self, stats):
        root = export(self, stats)
        tree = self.rt.tree
        leaves = [n for n in range(len(tree.children))
                  if not tree.children[n] and tree.name[n] != ""]
        a, b = leaves[3], leaves[-3]
        tree.name[a], tree.name[b] = tree.name[b], tree.name[a]
        return root

    def screen_nothing(*args, **kwargs):
        scores, rows = screen(*args, **kwargs)
        return scores.fill_(float("-inf")), rows

    if fault in ("state_unchanged", "half_batch"):
        monkeypatch.setattr(NativePlacementEngine, "place_batch_seeded",
                            place_seeded)
    elif fault == "answer_altered":
        monkeypatch.setattr(NativePlacementEngine, "export_to_tree",
                            export_to_tree)
    elif fault == "spr_skipped":
        monkeypatch.setattr(spr, "_parallel_update",
                            lambda run, params, abayes_on: (None, 0.0))
        monkeypatch.setattr(spr, "start_topology_updates",
                            lambda *args, **kwargs: (None, 0.0))
    elif fault == "screen_empty":
        monkeypatch.setattr(batch_spr, "spr_screen_step", screen_nothing)
    elif fault in ("em_skipped", "rates_initial"):
        monkeypatch.setattr(Run, "run_em_step",
                            lambda self, *args, **kwargs:
                            self.model.mut_matrix)
        if fault == "rates_initial":
            monkeypatch.setattr(Model, "update_from_pseudo_counts",
                                lambda self: False)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    return calls
