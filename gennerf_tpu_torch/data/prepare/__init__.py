"""ScanNet preparation: .sens export, info.json and splits, fused ground truth."""
