"""k1_scan_a_share_pct: the scan's pass A share of K1's time on the card
(%): the summed `k1.scan_a` durations (each window's sum over its scan
steps of the cost, latency, affinity hit and admission pass, from K1's
own `%globaltimer` stamps, read by the program's tracer) over the summed
`k1.call` durations. Nothing to read without the stamps: off the card,
or in a program without them."""


def read(view):
    spans = view.get("spans")
    if not spans or "k1.scan_a" not in spans or "k1.call" not in spans:
        return None
    call = spans["k1.call"]["total_s"]
    return 100.0 * spans["k1.scan_a"]["total_s"] / call if call > 0 else None
