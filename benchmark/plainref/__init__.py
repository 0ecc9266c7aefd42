"""The plain reference that decides ``correct``: its own detector (the
plain threshold and labelling, conic centres and grid matcher) and one
dense float64 Levenberg-Marquardt over the whole visual-inertial problem
(lm.py).  It imports nothing of the program."""
