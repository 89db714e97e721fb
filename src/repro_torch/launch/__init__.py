"""Launch tooling of the port: mesh construction and pspec normalisation
(``launch/mesh.py``) and the trainer CLI (``launch/train.py``).

The reference's shapes, analytics and dry-run (``repro/launch``) are
ROADMAP queue 1 item 2.5.
"""
