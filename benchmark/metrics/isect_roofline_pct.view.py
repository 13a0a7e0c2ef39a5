"""Percent of its roofline that the cluster intersection kernels reach: the
least time of the work a frame's closest-hit and occlusion calls need
(the reference's count on the checked frame, harness/arith.isect_call_s)
over the device time of every closest and occlusion launch a traced
frame makes (on several cards, summed over the ranks)."""

from harness import report


def read(rec):
    t = rec.get("isect_all_s")
    if t is None:
        t = report.isect_device_s(rec)
    bound = rec["bounds"].get("isect_s")
    if not t or not bound:
        return None
    return 100.0 * bound / (t / rec["units"])
