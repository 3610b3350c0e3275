"""The cutout bank's share of its roofline: its least time (bytes at
3.35 TB/s or float32 operations at 67 TFLOP/s, whichever is larger, K1
plus K2, every tower's bank, from each traced step's own count of jittered
cuts) over the device time between the bank's markers
(``layers/bank.json``)."""

from portbench.harness.counts import bank_bound_s

LAYERS = ("bank",)  # the marked layers it reads


def read(run):
    t = run.trace
    if t is None or not t["layer_ms"].get("bank") or not t["jittered"]:
        return None
    s = run.settings
    cuts = [s["towers"][name]["image_resolution"] for name in s["clip_models"]]
    bound = 0.0
    for per_tower in t["jittered"]:
        for cut, jittered in zip(cuts, per_tower):
            bound += sum(bank_bound_s(s["num_cuts"], jittered, cut, (cut, cut)))
    bound_ms = 1e3 * bound / len(t["jittered"])
    return 100.0 * bound_ms / t["layer_ms"]["bank"]
