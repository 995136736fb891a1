"""Port host data pipeline: corpus, transforms, synthetic clips, datasets."""
