"""corr_useful_pct: the share of the rows the correlation ran on that
could yield a detection, carrier-positive rows (the program's
``carrier_rows`` count) over ``corr_rows``, summed over the batches
finished in the window, in percent."""

from benchmark.harness import program


def read(ctx):
    return program.corr_useful_pct(ctx)
