"""The harness: the cells' loops, the frozen yardstick, the traced slice and
the checks that decide `correct`."""
