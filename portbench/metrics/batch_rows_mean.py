"""batch_rows_mean: requests per decided batch over the window's batches
(the benchmark's own count of its decision spans)."""


def read(view):
    return view["decided"] / view["batches"] if view["batches"] else None
