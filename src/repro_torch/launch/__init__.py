"""Launch tooling of the port: mesh construction and pspec normalisation
(``launch/mesh.py``), the trainer CLI (``launch/train.py``), the input
shapes (``shapes.py``), the analytic roofline (``analytic.py``), the
collective accounting (``comm_analysis.py``) and the multi-pod dry run
(``dryrun.py``).
"""
