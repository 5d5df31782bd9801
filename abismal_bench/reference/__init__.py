"""The plain reference that decides `correct` (check) and its control
(control)."""
