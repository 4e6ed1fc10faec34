"""The harness's general code: finding a cell's pieces, scenes, weights,
the door into the program, the traced window and the peaks."""
