"""Trainers: supervised policy, value regression, the evaluator, the
reinforcement stage, and the AlphaZero loop with its actors, learner and
curriculum."""
