"""sparse_rows_pct: fold rows the program computed over the window's
detections, as a share of what dense iterations would have computed (%):
the program's ``work_rows_history`` over iterations times the dense row
count. Read where the traffic compacts the fold to the frontier."""


def read(run):
    if not run.cell.lpa_fields().get("frontier_sparse"):
        return None
    rows = sum(r.work_rows for r in run.records)
    dense = sum(r.iterations for r in run.records) * run.dense_rows
    return rows / dense * 100 if dense else None
