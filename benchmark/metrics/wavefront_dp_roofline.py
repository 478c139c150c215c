"""wavefront_dp's share of its roofline, in %: the least time of each launch's
work (benchmark/roofline.py, from the pairs the spy read off the launch's
host-side batch) summed, over the profiled device time of every
wavefront_dp_kernel in the window."""

from benchmark.roofline import bound_s, wavefront_launch


def read(tr):
    dev_s = sum(e["t1"] - e["t0"] for e in tr.device
                if e["name"] == "wavefront_dp_kernel")
    if not tr.launches or dev_s <= 0:
        return None
    least = sum(bound_s(*wavefront_launch(x["pairs"], x["width"]))
                for x in tr.launches)
    return 100.0 * least / dev_s
