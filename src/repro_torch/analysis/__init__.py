"""The dry run's analysis: per-rank op counts of a step (`op_trace`), the
H100 roofline built from them (`roofline`), and a cell's top dots and
collectives (`inspect`)."""
