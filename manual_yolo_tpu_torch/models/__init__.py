"""YOLOv8 detect/classify graphs and the rank classifier, in PyTorch."""
