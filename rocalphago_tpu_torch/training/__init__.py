"""Trainers: supervised policy, value regression, the evaluator."""
