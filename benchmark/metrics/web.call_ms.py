"""Mean host milliseconds of one ``Predictor.predict_images`` call (PIL
resize of every image, staging, forward, fetch), timed by the harness's
proxy over the window."""


def read(readings: dict):
    calls = readings.get("predict_calls") or []
    if not calls:
        return None
    return sum(ms for _, ms in calls) / len(calls)
