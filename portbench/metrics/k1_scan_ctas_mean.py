"""k1_scan_ctas_mean: the CTAs that ran each of K1's window scans, on
average over the window's `k1.scan` records (1 where one CTA scans, the
cluster's size on the cluster carry): the summed `ctas` counter over the
count of records. Nothing to read without the stamps or without the
`ctas` counter: off the card, or in a program that does not count
them."""


def read(view):
    spans = view.get("spans")
    scan = spans.get("k1.scan") if spans else None
    ctas = scan["sums"].get("ctas") if scan else None
    return ctas / scan["count"] if ctas is not None and scan["count"] else None
