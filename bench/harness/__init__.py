"""The general harness: the code of each kind of traffic (`fit`, `predict`),
the device trace, and the run that ties them to the data files."""
