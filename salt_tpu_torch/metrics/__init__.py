"""IoU / IOUT metrics (numpy reference semantics and a torch batch path)."""
