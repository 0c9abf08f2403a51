"""Mean images per ``Predictor.predict_images`` call of the daemon's worker
(one call a micro-batch), counted by the harness's proxy over the window."""


def read(readings: dict):
    calls = readings.get("predict_calls") or []
    if not calls:
        return None
    return sum(n for n, _ in calls) / len(calls)
