"""The least time a device step's work needs on a card, and a step's share
of it: the arithmetic the roofline readers share.

A step (``proxy_step``, ``spr_screen_step``) is one ``[k, D] x [D, r]``
product of its real queries against the rows that hold anchors, with the
scatter of the changed rows before it and the top-M after it.  Its work,
whatever implements it:

- FLOPs: 2 k D r;
- bytes: the r rows of D elements read once and their masks, the k
  queries' sparse features (index and float32 weight), each changed row's
  features read and its D elements written, and the [k, M] top-M written
  (float32 score and int64 row).

The bound is the larger of FLOPs over the float32 peak outside the tensor
cores and bytes over the memory bandwidth (``benchmark/device/*.json``):
the configurations state float32 with TF32 off.  A change that moves the
product onto the tensor cores needs this file recounted against that
precision's peak.
"""


def work_counts(w):
    """(FLOPs, bytes) of one step's record ``w`` (``trace.StepWork``)."""
    r, k, D, e = w["rows"], w["queries"], w["D"], w["elem"]
    flops = 2.0 * k * D * r
    nbytes = (r * D * e + r * w["row_mask_bytes"]
              + k * w["q_feats"] * (w["q_index_bytes"] + 4)
              + w["changed"] * (w["a_feats"] * (w["a_index_bytes"] + 4)
                                + 9 + D * e)
              + k * w["topm"] * 12)
    return flops, nbytes


def bound_s(w, peaks):
    """(seconds, "flops" or "bytes"): the least time of ``w``'s work."""
    flops, nbytes = work_counts(w)
    tf = flops / peaks["f32_flops_per_s"]
    tb = nbytes / peaks["hbm_bytes_per_s"]
    return (tf, "flops") if tf >= tb else (tb, "bytes")


def share(records, kind):
    """Percent: the steps' summed bounds over the device time of every
    kernel launched inside their spans; None without steps, a trace or
    the card's peaks."""
    if records.trace is None or records.peaks is None:
        return None
    steps = [w for w in records.work if w["kind"] == kind]
    device_s = records.trace["span_device_s"].get(kind, 0.0)
    if not steps or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(w, records.peaks)[0] for w in steps) \
        / device_s
