"""integrity.crc32_fold_pct (%): the share of the bytes the program's
crc32 hashed in the window that the carry-less-multiply fold hashed, by
its counter ``host_crc32_bytes{impl=fold|zlib}`` summed over the
window's reports (traced runs); None where no report counted any, as
for a program without the counter."""


def read(run):
    total = sum(r.metrics.counter_total("host_crc32_bytes") for r in run.reports)
    if not total:
        return None
    fold = sum(r.metrics.counter_total("host_crc32_bytes", impl="fold") for r in run.reports)
    return fold / total * 100
