"""The benchmark's harness: cells found by name (cell.py), the timed
window and the result's line (run_cell.py), spans put on from outside the
program (spans.py), the trace's reading (trace.py), the yardstick's counts
(costs.py), the check against the plain reference (check.py) and the
faults it has to catch (faults.py)."""
