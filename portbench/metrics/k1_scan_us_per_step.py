"""k1_scan_us_per_step: K1's scan time a step on the card (us): the summed
`k1.scan` durations (each window's scan, its preamble and greedy loop,
from K1's own `%globaltimer` stamps, read by the program's tracer) over
the summed `steps` of those records (the steps each window's loop ran).
Nothing to read without the stamps or without the `steps` counter: off
the card, or in a program that does not count the steps."""


def read(view):
    spans = view.get("spans")
    scan = spans.get("k1.scan") if spans else None
    steps = scan["sums"].get("steps") if scan else None
    return 1e6 * scan["total_s"] / steps if steps else None
