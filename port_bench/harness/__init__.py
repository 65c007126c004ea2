"""The measured run: set-up, warm-up, window, spans, profile, result line."""
