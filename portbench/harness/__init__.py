"""The benchmark harness of the port: host conditions (host.py), the one
traffic generator (inputs.py), the entries that drive the system under test
(entries.py), the comparison with the reference (check.py), the trace's
reduction (trace.py), the work model of the rooflines (work_model.py), the
faults of the control and its tests (faults.py) and one run of a cell
(cell.py).  Torch and the port are imported inside functions only, so the
reference's worker processes, which import check.py and inputs.py, load
neither."""
