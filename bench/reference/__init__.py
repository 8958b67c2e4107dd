"""The benchmark's yardstick: the float64 plain reference (`apnc`), the data
generator (`blobs`) and the comparison that decides ``correct`` (`judge`).
Nothing here imports the program."""
