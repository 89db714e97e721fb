"""Launch tooling of the port: the trainer CLI (``launch/train.py``).

The reference's mesh construction, shapes, analytics and dry-run
(``repro/launch``) are ROADMAP queue 1 item 2.5.
"""
