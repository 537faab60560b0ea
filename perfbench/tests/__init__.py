"""CPU tests of the benchmark; those marked ``cuda`` run only on the card."""
