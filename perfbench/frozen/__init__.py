"""Frozen copies of what the benchmark needs from the program: the data
generators, the table of published peaks and the analytic FLOP count.
Later changes to the program do not move the yardstick."""
