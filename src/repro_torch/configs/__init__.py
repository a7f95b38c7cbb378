"""Model / run configs (reference: ``src/repro/configs``).

Only the paper's LSTM (``paper_lstm``) is ported so far.
"""
