"""Plain PyTorch references of the configurations' families, in
float32 with TF32 off. They import nothing of the program: the
benchmark hands them the same weights and inputs it hands the program,
and they work out the results again."""
